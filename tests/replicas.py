"""Independent numpy replicas of the grid operators, for the parametrised
operator tests.  Written from the textbook definitions with explicit zero
fill outside the array (no rolls), so they share no code with the jnp
operators they check."""

import numpy as np


def shift(u, di, dj):
    """u[i+di, j+dj], zero outside the array."""
    out = np.zeros_like(u)
    S0, S1 = u.shape
    src_i = slice(max(di, 0), S0 + min(di, 0))
    dst_i = slice(max(-di, 0), S0 + min(-di, 0))
    src_j = slice(max(dj, 0), S1 + min(dj, 0))
    dst_j = slice(max(-dj, 0), S1 + min(-dj, 0))
    out[dst_i, dst_j] = u[src_i, src_j]
    return out


def interior(shape, n):
    m = np.zeros(shape, bool)
    m[1:n, 1:n] = True
    return m


def box_mask(shape, box):
    i0, i1, j0, j1 = box
    m = np.zeros(shape, bool)
    m[i0:i1 + 1, j0:j1 + 1] = True
    return m


def random_interior(n, S, rng, scale=1.0):
    u = np.zeros((S, S))
    u[1:n, 1:n] = rng.standard_normal((n - 1, n - 1)) * scale
    return u


# -- 5-point constant stencil -------------------------------------------------

def nbr5(u):
    return shift(u, -1, 0) + shift(u, 1, 0) + shift(u, 0, -1) + shift(u, 0, 1)


def apply5(u, n):
    return np.where(interior(u.shape, n), 4.0 * u - nbr5(u), 0.0)


def residual5(u, b, n):
    return np.where(interior(u.shape, n), b - 4.0 * u + nbr5(u), 0.0)


def jacobi5(u, b, n, weights):
    m = interior(u.shape, n)
    v = u.copy()
    for w in weights:
        v = np.where(m, (1 - w) * v + 0.25 * w * (b + nbr5(v)), 0.0)
    return v


def rbgs5(u, b, n, sweeps):
    m = interior(u.shape, n)
    i, j = np.indices(u.shape)
    v = u.copy()
    for _ in range(sweeps):
        for parity in (0, 1):
            upd = m & ((i + j) % 2 == parity)
            v = np.where(upd, 0.25 * (b + nbr5(v)), v)
    return v


# -- transfers ---------------------------------------------------------------

FW = np.array([[0.25, 0.5, 0.25], [0.5, 1.0, 0.5], [0.25, 0.5, 0.25]])


def restrict_fw(r, nf, Sc, box=None):
    """rc[I, J] = sum_ab FW[a, b] r[2I+a, 2J+b] on the coarse unknowns."""
    nc = nf // 2
    rc = np.zeros((Sc, Sc))
    for a in (-1, 0, 1):
        for b in (-1, 0, 1):
            s = shift(r, a, b)
            take = s[0:2 * Sc:2, 0:2 * Sc:2]
            rc[:take.shape[0], :take.shape[1]] += FW[a + 1, b + 1] * take
    m = box_mask(rc.shape, box) if box is not None else interior(rc.shape,
                                                                  nc)
    return np.where(m, rc, 0.0)


def prolong(e, nc, Sf, box=None, diag="bilinear"):
    """Bilinear (or P1 criss-cross) interpolation of the coarse grid."""
    nf = 2 * nc
    f = np.zeros((Sf, Sf))
    E = np.zeros((Sf + 2, Sf + 2))
    m = min(e.shape[0], Sf + 2)
    E[:m, :m] = e[:m, :m]
    for I in range(0, nc + 1):
        for J in range(0, nc + 1):
            c = E[I, J]
            if 2 * I < Sf and 2 * J < Sf:
                f[2 * I, 2 * J] = c
            if 2 * I + 1 < Sf and 2 * J < Sf:
                f[2 * I + 1, 2 * J] = 0.5 * (c + E[I + 1, J])
            if 2 * I < Sf and 2 * J + 1 < Sf:
                f[2 * I, 2 * J + 1] = 0.5 * (c + E[I, J + 1])
            if 2 * I + 1 < Sf and 2 * J + 1 < Sf:
                if diag == "bilinear":
                    f[2 * I + 1, 2 * J + 1] = 0.25 * (
                        c + E[I, J + 1] + E[I + 1, J] + E[I + 1, J + 1])
                else:
                    f[2 * I + 1, 2 * J + 1] = 0.5 * (E[I, J + 1]
                                                     + E[I + 1, J])
    msk = box_mask(f.shape, box) if box is not None else interior(f.shape,
                                                                  nf)
    return np.where(msk, f, 0.0)


def restrict_injection(r, nf, Sc):
    nc = nf // 2
    rc = np.zeros((Sc, Sc))
    take = r[0:2 * Sc:2, 0:2 * Sc:2]
    rc[:take.shape[0], :take.shape[1]] = 4.0 * take
    return np.where(interior(rc.shape, nc), rc, 0.0)


# -- 9-point operators -------------------------------------------------------

def mehrstellen_off(u):
    cross = nbr5(u)
    diag = (shift(u, -1, -1) + shift(u, -1, 1) + shift(u, 1, -1)
            + shift(u, 1, 1))
    return (4.0 * cross + diag) / 6.0


def apply9(u, n):
    return np.where(interior(u.shape, n), 20.0 / 6.0 * u - mehrstellen_off(u),
                    0.0)


def jacobi9(u, b, n, weights):
    m = interior(u.shape, n)
    v = u.copy()
    for w in weights:
        v = np.where(m, (1 - w) * v + w * 6.0 / 20.0
                     * (b + mehrstellen_off(v)), 0.0)
    return v


def var_apply(coef, u, mask):
    acc = np.zeros_like(u)
    for di in (-1, 0, 1):
        for dj in (-1, 0, 1):
            acc += coef[di + 1, dj + 1] * shift(u, di, dj)
    return np.where(mask, acc, 0.0)


def var_jacobi(coef, u, b, mask, weights):
    d = coef[1, 1]
    inv_d = np.where(mask, 1.0 / np.where(mask, d, 1.0), 0.0)
    v = u.copy()
    for w in weights:
        off = var_apply(coef, v, np.ones_like(mask)) - d * v
        v = np.where(mask, (1 - w) * v + w * inv_d * (b - off), 0.0)
    return v


def var_rbgs(coef, u, b, mask, sweeps):
    d = coef[1, 1]
    inv_d = np.where(mask, 1.0 / np.where(mask, d, 1.0), 0.0)
    i, j = np.indices(u.shape)
    v = u.copy()
    for _ in range(sweeps):
        for parity in (0, 1):
            upd = mask & ((i + j) % 2 == parity)
            vn = v + inv_d * (b - var_apply(coef, v, mask))
            v = np.where(upd, vn, v)
    return v


def zebra(coef, u, b, n, sweeps, axis):
    """Zebra line relaxation, each line solved exactly by a dense solve."""
    v = u.copy()
    S = u.shape[0]
    for _ in range(sweeps):
        for parity in (1, 0):
            new = v.copy()
            for line in range(1, n):
                if line % 2 != parity:
                    continue
                idx = np.arange(1, n)
                if axis == 1:          # a row: unknowns (line, idx)
                    A = (np.diag(coef[1, 1, line, idx])
                         + np.diag(coef[1, 2, line, idx[:-1]], 1)
                         + np.diag(coef[1, 0, line, idx[1:]], -1))
                    rhs = b[line, idx].copy()
                    for di in (-1, 1):
                        for dj in (-1, 0, 1):
                            rhs -= coef[di + 1, dj + 1, line, idx] * \
                                v[line + di, idx + dj]
                    new[line, idx] = np.linalg.solve(A, rhs)
                else:                  # a column: unknowns (idx, line)
                    A = (np.diag(coef[1, 1, idx, line])
                         + np.diag(coef[2, 1, idx[:-1], line], 1)
                         + np.diag(coef[0, 1, idx[1:], line], -1))
                    rhs = b[idx, line].copy()
                    for dj in (-1, 1):
                        for di in (-1, 0, 1):
                            rhs -= coef[di + 1, dj + 1, idx, line] * \
                                v[idx + di, line + dj]
                    new[idx, line] = np.linalg.solve(A, rhs)
            v = new
    assert v.shape == (S, S)
    return v


# -- 3D 7-point --------------------------------------------------------------

def shift3(u, d):
    out = np.zeros_like(u)
    src, dst = [], []
    for ax, s in enumerate(d):
        L = u.shape[ax]
        src.append(slice(max(s, 0), L + min(s, 0)))
        dst.append(slice(max(-s, 0), L + min(-s, 0)))
    out[tuple(dst)] = u[tuple(src)]
    return out


def interior3(shape, n):
    m = np.zeros(shape, bool)
    m[1:n, 1:n, 1:n] = True
    return m


def nbr7(u):
    acc = np.zeros_like(u)
    for ax in range(3):
        for s in (-1, 1):
            d = [0, 0, 0]
            d[ax] = s
            acc += shift3(u, d)
    return acc


def apply7(u, n):
    return np.where(interior3(u.shape, n), 6.0 * u - nbr7(u), 0.0)


def jacobi7(u, b, n, weights):
    m = interior3(u.shape, n)
    v = u.copy()
    for w in weights:
        v = np.where(m, (1 - w) * v + w / 6.0 * (b + nbr7(v)), 0.0)
    return v


def restrict_fw3(r, nf, Sc):
    """R = P^T / 2 (the 3D FD-consistency factor of core.ops3d)."""
    nc = nf // 2
    w1 = {-1: 0.5, 0: 1.0, 1: 0.5}
    rc = np.zeros((Sc,) * 3)
    for a in (-1, 0, 1):
        for b in (-1, 0, 1):
            for c in (-1, 0, 1):
                s = shift3(r, (a, b, c))[0:2 * Sc:2, 0:2 * Sc:2, 0:2 * Sc:2]
                rc[:s.shape[0], :s.shape[1], :s.shape[2]] += (
                    0.5 * w1[a] * w1[b] * w1[c] * s)
    return np.where(interior3(rc.shape, nc), rc, 0.0)


def prolong3(e, nc, Sf):
    nf = 2 * nc
    f = np.zeros((Sf,) * 3)
    E = np.zeros((nc + 2,) * 3)
    m = min(e.shape[0], nc + 2)
    E[:m, :m, :m] = e[:m, :m, :m]
    for p in np.ndindex(2, 2, 2):
        # fine node 2I + p averages the 2^(#odd axes) coarse corners
        acc = np.zeros((nc + 1,) * 3)
        cnt = 0
        for q in np.ndindex(*(2 if pi else 1 for pi in p)):
            acc += E[q[0]:q[0] + nc + 1, q[1]:q[1] + nc + 1,
                     q[2]:q[2] + nc + 1]
            cnt += 1
        blk = acc / cnt
        sl = tuple(slice(pi, min(Sf, 2 * (nc + 1)), 2) for pi in p)
        tgt = f[sl]
        f[sl] = blk[:tgt.shape[0], :tgt.shape[1], :tgt.shape[2]]
    return np.where(interior3(f.shape, nf), f, 0.0)
