"""General-DOF (topology-metadata-driven) multigrid.

The reference's WIP v2 library describes multigrid over *arbitrary* DOF
numberings: a ``ProblemVar`` filled from Python with per-level CSR operators,
``topo_to_space_dict`` (topological node id -> FEM-space dof),
``parent_info_dict`` (fine topo dof -> (0, coarse vertex) or (1, coarse
edge)) and ``coarse_grid_edges_dict`` (edge id -> its two endpoint vertices)
(``Multigrid_functions.cpp:16-26``); its transfers walk those dicts one dof
at a time on the host (``interpolation2D`` ``:98-118``, ``restriction2D``
``:122-130``).

TPU-native equivalent: the dicts become **static int32 gather tables** built
once at setup, so prolongation is one gather-pair + average and restriction
is one gather (static shapes, no host loops, no data-dependent control
flow); per-level operators are **ELL** (padded-row) sparse matrices whose
apply is a batched gather + small dense reduction that XLA vectorizes; the
smoother is the precomputed-``D^-1`` weighted Jacobi of the reference's v2
``jacobirelaxation`` (``Multigrid_functions.cpp:75-96``) with the ``omega =
4/5`` integer-division bug (``:48``) not reproduced.

This path trades the structured-grid operators' bandwidth optimality
for full generality (any nested P1 mesh, any DOF permutation); the
structured solver remains the fast path.  Eliminated (Dirichlet) neighbors
are represented by one trailing zero slot in every gathered vector, so no
masking or dynamic shapes are needed.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Optional, Sequence, Tuple, Union

import jax
import jax.numpy as jnp
import numpy as np


# ---------------------------------------------------------------------------
# Transfers
# ---------------------------------------------------------------------------

@jax.tree_util.register_pytree_node_class
class TopoTransfer:
    """Gather-table form of the reference's metadata-driven transfers.

    ``src0`` / ``src1``: (m_f,) int32 indices into the *extended* coarse
    space vector (index ``m_c`` is a zero slot for Dirichlet-eliminated
    parents).  A fine dof coinciding with a coarse vertex has
    ``src0 == src1`` (so the 0.5-average injects); an edge-midpoint dof
    carries the edge's two endpoints (``interpolation2D``,
    ``Multigrid_functions.cpp:98-118``).

    ``inj``: (m_c,) int32 index of the coinciding fine dof per coarse dof
    (``restriction2D``, ``Multigrid_functions.cpp:122-130``).

    ``restrict_scale``: static scaling of the injected residual.  The
    variational row-sum normalization for the h-independent FEM stencil is
    4.0 (matching R = P^T, which maps constants c -> 4c in 2D); the
    reference's WIP code injects unscaled (scale 1.0), which under-weights
    coarse corrections 4x — both are available, 4.0 is the default.

    ``variational``: replace the injection restriction with the true
    transpose R = P^T (a segment-sum over the same gather tables).  On any
    *nested* P1 pair the re-assembled coarse operator equals the Galerkin
    product P^T A_f P exactly, so this mode gives the variational method on
    unstructured meshes (trimesh.py) where plain injection has no
    row-sum normalization to lean on.
    """

    def __init__(self, src0, src1, inj, restrict_scale: float = 4.0,
                 variational: bool = False):
        self.src0 = src0
        self.src1 = src1
        self.inj = inj
        self.restrict_scale = float(restrict_scale)
        self.variational = bool(variational)

    def tree_flatten(self):
        return ((self.src0, self.src1, self.inj),
                (self.restrict_scale, self.variational))

    @classmethod
    def tree_unflatten(cls, aux, children):
        return cls(*children, restrict_scale=aux[0], variational=aux[1])

    @property
    def m_fine(self) -> int:
        return self.src0.shape[0]

    @property
    def m_coarse(self) -> int:
        return self.inj.shape[0]

    def prolong(self, ec: jnp.ndarray) -> jnp.ndarray:
        """Coarse space vector (m_c,) -> fine space vector (m_f,)."""
        ext = jnp.concatenate([ec, jnp.zeros((1,), ec.dtype)])
        half = jnp.asarray(0.5, ec.dtype)
        return half * (ext[self.src0] + ext[self.src1])

    def restrict(self, rf: jnp.ndarray) -> jnp.ndarray:
        """Fine space vector (m_f,) -> coarse space vector (m_c,)."""
        if self.variational:
            # R = P^T: scatter-add each fine dof's half-weight to both
            # parents.  Eliminated parents alias the trailing slot m_c,
            # which the final slice drops (the transpose of prolong's
            # zero-padded gather).
            half = jnp.asarray(0.5, rf.dtype) * rf
            acc = (jax.ops.segment_sum(half, self.src0,
                                       num_segments=self.m_coarse + 1)
                   + jax.ops.segment_sum(half, self.src1,
                                         num_segments=self.m_coarse + 1))
            return acc[:self.m_coarse]
        return jnp.asarray(self.restrict_scale, rf.dtype) * rf[self.inj]

    def __repr__(self):
        return (f"TopoTransfer(m_f={self.m_fine}, m_c={self.m_coarse}, "
                f"scale={self.restrict_scale})")


def transfer_from_metadata(
    parent_info: Dict[int, Tuple[int, int]],
    coarse_edges: Dict[int, Tuple[int, int]],
    topo_to_space_fine: Dict[int, int],
    topo_to_space_coarse: Dict[int, int],
    coincident_fine_topo: Dict[int, int],
    m_fine: int,
    m_coarse: int,
    restrict_scale: float = 4.0,
    variational: bool = False,
) -> TopoTransfer:
    """Build gather tables from reference-shaped metadata dicts.

    Arguments mirror ``ProblemVar`` (``Multigrid_functions.cpp:16-26``):
    ``parent_info[fine_topo] = (0, coarse_vertex_topo)`` or ``(1, edge_id)``;
    ``coarse_edges[edge_id] = (v0_topo, v1_topo)``; the ``topo_to_space``
    maps send topological ids to space dofs (-1 / absent = eliminated
    boundary dof); ``coincident_fine_topo[coarse_topo]`` is the fine topo id
    sitting at the same physical node (the structured case uses the identity
    the reference hard-codes in ``restriction2D:126-128``).
    """
    src0 = np.full(m_fine, m_coarse, np.int32)
    src1 = np.full(m_fine, m_coarse, np.int32)

    def cspace(topo: int) -> int:
        s = topo_to_space_coarse.get(topo, -1)
        return s if s >= 0 else m_coarse

    for ftopo, (kind, parent) in parent_info.items():
        fs = topo_to_space_fine.get(ftopo, -1)
        if fs < 0:
            continue  # boundary fine dof: eliminated
        if kind == 0:
            s = cspace(parent)
            src0[fs] = s
            src1[fs] = s
        else:
            v0, v1 = coarse_edges[parent]
            src0[fs] = cspace(v0)
            src1[fs] = cspace(v1)

    inj = np.zeros(m_coarse, np.int32)
    for ctopo, cs in topo_to_space_coarse.items():
        if cs < 0:
            continue
        ftopo = coincident_fine_topo[ctopo]
        fs = topo_to_space_fine.get(ftopo, -1)
        assert fs >= 0, "coarse interior dof must coincide with a fine interior dof"
        inj[cs] = fs

    return TopoTransfer(jnp.asarray(src0), jnp.asarray(src1),
                        jnp.asarray(inj), restrict_scale,
                        variational=variational)


def structured_metadata(nf: int, perm_f: Optional[np.ndarray] = None,
                        perm_c: Optional[np.ndarray] = None):
    """Reference-shaped metadata dicts for the unit-square criss-cross mesh.

    Fine grid has ``nf`` cells per side; the coarse grid ``nf // 2``.  Topo
    ids are row-major node ids over the full ``(n+1)^2`` node grids (the
    reference's numbering, ``Poissons_SYCL.cpp:188-198``); space dofs are
    the interior nodes, row-major, optionally renumbered by ``perm_f`` /
    ``perm_c`` (arrays of length ``(n-1)^2`` — the ``topo_to_space_dict``
    generality the structured fast path hard-codes away).

    Per fine interior node (i, j): even-even coincides with coarse vertex
    (i/2, j/2); odd-even sits on a vertical coarse edge; even-odd on a
    horizontal edge; odd-odd on the *diagonal* edge of the criss-cross
    triangulation, from (i//2+1, j//2) to (i//2, j//2+1) (matching
    ``core.ops.prolong_p1`` and ``interpolation2D``'s edge-average cases).
    """
    nc = nf // 2
    if nc < 1 or nf % 2:
        raise ValueError("nf must be even and >= 2")
    mf, mc = (nf - 1) ** 2, (nc - 1) ** 2

    def space_maps(n, perm):
        m = {}
        k = 0
        for i in range(1, n):
            for j in range(1, n):
                s = k if perm is None else int(perm[k])
                m[i * (n + 1) + j] = s
                k += 1
        return m

    t2s_f = space_maps(nf, perm_f)
    t2s_c = space_maps(nc, perm_c)

    parent_info: Dict[int, Tuple[int, int]] = {}
    coarse_edges: Dict[int, Tuple[int, int]] = {}
    edge_ids: Dict[Tuple[int, int], int] = {}

    def edge(v0: int, v1: int) -> int:
        key = (v0, v1) if v0 <= v1 else (v1, v0)
        if key not in edge_ids:
            eid = len(edge_ids)
            edge_ids[key] = eid
            coarse_edges[eid] = key
        return edge_ids[key]

    def cnode(ic, jc):
        return ic * (nc + 1) + jc

    for i in range(1, nf):
        for j in range(1, nf):
            ftopo = i * (nf + 1) + j
            if i % 2 == 0 and j % 2 == 0:
                parent_info[ftopo] = (0, cnode(i // 2, j // 2))
            elif i % 2 == 1 and j % 2 == 0:
                parent_info[ftopo] = (
                    1, edge(cnode(i // 2, j // 2), cnode(i // 2 + 1, j // 2)))
            elif i % 2 == 0 and j % 2 == 1:
                parent_info[ftopo] = (
                    1, edge(cnode(i // 2, j // 2), cnode(i // 2, j // 2 + 1)))
            else:
                parent_info[ftopo] = (
                    1, edge(cnode(i // 2 + 1, j // 2),
                            cnode(i // 2, j // 2 + 1)))

    coincident = {cnode(ic, jc): (2 * ic) * (nf + 1) + (2 * jc)
                  for ic in range(nc + 1) for jc in range(nc + 1)}

    return dict(parent_info=parent_info, coarse_edges=coarse_edges,
                topo_to_space_fine=t2s_f, topo_to_space_coarse=t2s_c,
                coincident_fine_topo=coincident, m_fine=mf, m_coarse=mc)


def structured_transfer(nf: int, perm_f: Optional[np.ndarray] = None,
                        perm_c: Optional[np.ndarray] = None,
                        restrict_scale: float = 4.0) -> TopoTransfer:
    """TopoTransfer for the structured criss-cross mesh (via the metadata)."""
    md = structured_metadata(nf, perm_f, perm_c)
    return transfer_from_metadata(restrict_scale=restrict_scale, **md)


# ---------------------------------------------------------------------------
# ELL sparse operators
# ---------------------------------------------------------------------------

@jax.tree_util.register_pytree_node_class
class EllOp:
    """Padded-row (ELL) sparse operator: the TPU-friendly CSR replacement.

    The reference applies per-level CSR matrices with oneMKL sparse gemv
    (``Multigrid_functions.cpp:87-90,150-151``); CSR's row-pointer
    indirection is hostile to XLA (ragged rows = dynamic shapes).  ELL pads
    every row to the max row degree ``k`` (7 for interior P1 criss-cross
    dofs), making the apply a dense (m, k) gather + row-sum — static shapes,
    fully vectorized.  Padded slots point at the trailing zero slot with
    zero coefficients.

    ``d_inv`` is the precomputed inverse diagonal — the v2 design's
    ``A_jacobi_sp_dict['D_inv']`` (``Multigrid_functions.cpp:19-21``) and
    the ``inverse_diagonal`` helper the compiled reference never calls
    (``Poissons_SYCL.cpp:652-656``).
    """

    def __init__(self, cols, vals, d_inv):
        self.cols = cols
        self.vals = vals
        self.d_inv = d_inv

    def tree_flatten(self):
        return (self.cols, self.vals, self.d_inv), ()

    @classmethod
    def tree_unflatten(cls, _aux, children):
        return cls(*children)

    @property
    def m(self) -> int:
        return self.cols.shape[0]

    def apply(self, u: jnp.ndarray) -> jnp.ndarray:
        ext = jnp.concatenate([u, jnp.zeros((1,), u.dtype)])
        return jnp.sum(self.vals.astype(u.dtype) * ext[self.cols], axis=1)

    def residual(self, u: jnp.ndarray, b: jnp.ndarray) -> jnp.ndarray:
        return b - self.apply(u)

    def jacobi(self, u, b, omega: Union[float, Tuple[float, ...]],
               sweeps: int) -> jnp.ndarray:
        """v2 weighted Jacobi, precomputed D^-1 form: ``u += w D^-1 (b-Au)``
        == ``R_w u + w D^-1 b`` (``Multigrid_functions.cpp:87-92``).  Accepts
        a per-sweep weight tuple (Chebyshev schedule) like the grid path."""
        dinv = self.d_inv.astype(u.dtype)
        ws = omega if isinstance(omega, tuple) else (omega,) * sweeps
        for s in range(sweeps):
            w = jnp.asarray(ws[s % len(ws)], u.dtype)
            u = u + w * dinv * self.residual(u, b)
        return u

    def __repr__(self):
        return f"EllOp(m={self.m}, k={self.cols.shape[1]})"


def ell_from_dense(A: np.ndarray, tol: float = 0.0) -> EllOp:
    """Convert a dense (m, m) operator to ELL (drop |a| <= tol)."""
    A = np.asarray(A)
    m = A.shape[0]
    rows = [np.nonzero(np.abs(A[i]) > tol)[0] for i in range(m)]
    k = max((len(r) for r in rows), default=1)
    k = max(k, 1)
    cols = np.full((m, k), m, np.int32)
    vals = np.zeros((m, k), A.dtype)
    for i, r in enumerate(rows):
        cols[i, :len(r)] = r
        vals[i, :len(r)] = A[i, r]
    d = np.diag(A).copy()
    if np.any(d == 0):
        raise ValueError("zero diagonal entry")
    return EllOp(jnp.asarray(cols), jnp.asarray(vals),
                 jnp.asarray(1.0 / d))


def ell_from_coo(rows: np.ndarray, cols: np.ndarray, vals: np.ndarray,
                 m: int) -> EllOp:
    """COO triplets (with duplicates summed, float-correct) -> EllOp.

    The duplicate merge the reference's ``coo_to_csr`` performs — without
    its float->int truncation bug (``Poissons_SYCL.cpp:93``).
    """
    order = np.lexsort((np.asarray(cols), np.asarray(rows)))
    r, c, v = (np.asarray(rows)[order], np.asarray(cols)[order],
               np.asarray(vals, np.float64)[order])
    keep = np.ones(len(r), bool)
    keep[1:] = (r[1:] != r[:-1]) | (c[1:] != c[:-1])
    idx = np.cumsum(keep) - 1
    vm = np.zeros(int(idx[-1]) + 1 if len(idx) else 0)
    np.add.at(vm, idx, v)
    rm, cm = r[keep], c[keep]
    nz = vm != 0.0
    rm, cm, vm = rm[nz], cm[nz], vm[nz]
    counts = np.bincount(rm, minlength=m)
    k = max(int(counts.max()) if m else 1, 1)
    row_start = np.concatenate([[0], np.cumsum(counts)])
    pos = np.arange(len(rm)) - row_start[rm]
    cols_ell = np.full((m, k), m, np.int32)
    vals_ell = np.zeros((m, k))
    cols_ell[rm, pos] = cm
    vals_ell[rm, pos] = vm
    d = np.zeros(m)
    diag = rm == cm
    d[rm[diag]] = vm[diag]
    if np.any(d == 0):
        raise ValueError("zero diagonal entry")
    return EllOp(jnp.asarray(cols_ell), jnp.asarray(vals_ell),
                 jnp.asarray(1.0 / d))


# ---------------------------------------------------------------------------
# Hierarchy + cycles
# ---------------------------------------------------------------------------

@jax.tree_util.register_pytree_node_class
class TopoHierarchy:
    """Static stack of ELL operators + topo transfers (finest first).

    The general-DOF analogue of ``core.grids.Hierarchy``; ``coarse_inv`` is
    the dense inverse of the coarsest operator (the v2 Eigen-SparseLU
    intent, ``Multigrid_functions.cpp:63-72``), applied as one matvec.
    ``b_levels`` optionally carries per-level assembled RHS for the v2 FMG
    semantics (``b_dict``, ``Multigrid_functions.cpp:24,184``).
    """

    def __init__(self, ops: Tuple[EllOp, ...],
                 transfers: Tuple[TopoTransfer, ...],
                 coarse_inv: jnp.ndarray,
                 b_levels: Optional[Tuple[jnp.ndarray, ...]] = None):
        assert len(transfers) == len(ops) - 1
        self.ops = tuple(ops)
        self.transfers = tuple(transfers)
        self.coarse_inv = coarse_inv
        self.b_levels = None if b_levels is None else tuple(b_levels)

    def tree_flatten(self):
        return (self.ops, self.transfers, self.coarse_inv, self.b_levels), ()

    @classmethod
    def tree_unflatten(cls, _aux, children):
        return cls(*children)

    @property
    def num_levels(self) -> int:
        return len(self.ops)


def _coarse_apply(hier: TopoHierarchy, b):
    """Dense coarse solve; HIGHEST keeps a float32 product out of TF32."""
    return jnp.matmul(hier.coarse_inv, b.astype(hier.coarse_inv.dtype),
                      precision=jax.lax.Precision.HIGHEST)


def vcycle_topo(hier: TopoHierarchy, u, b, *, nu1: int = 3, nu2: int = 3,
                omega: Union[float, Tuple[float, ...]] = 2.0 / 3.0,
                k: int = 0, cycle: str = "V"):
    """One V/W cycle over space vectors (``vcyclemultigrid`` v2,
    ``Multigrid_functions.cpp:132-173``, as one traced XLA program)."""
    op = hier.ops[k]
    if k == hier.num_levels - 1:
        return _coarse_apply(hier, b).astype(b.dtype)
    t = hier.transfers[k]
    u = op.jacobi(u, b, omega, nu1)
    rc = t.restrict(op.residual(u, b))
    ec = jnp.zeros((t.m_coarse,), u.dtype)
    ec = vcycle_topo(hier, ec, rc, nu1=nu1, nu2=nu2, omega=omega,
                     k=k + 1, cycle=cycle)
    if cycle == "W" and k + 1 < hier.num_levels - 1:
        ec = vcycle_topo(hier, ec, rc, nu1=nu1, nu2=nu2, omega=omega,
                         k=k + 1, cycle=cycle)
    u = u + t.prolong(ec)
    return op.jacobi(u, b, omega, nu2)


def fmg_topo(hier: TopoHierarchy, *, nu0: int = 3, nu1: int = 3,
             nu2: int = 3, omega: Union[float, Tuple[float, ...]] = 2.0 / 3.0,
             dtype=jnp.float32):
    """Full multigrid with per-level *assembled* RHS (``fullmultigrid`` v2,
    ``Multigrid_functions.cpp:175-191``): requires ``hier.b_levels``."""
    if hier.b_levels is None:
        raise ValueError("fmg_topo requires hier.b_levels (v2 b_dict)")
    kc = hier.num_levels - 1
    bs = [b.astype(dtype) for b in hier.b_levels]
    u = _coarse_apply(hier, bs[kc]).astype(dtype)
    for k in range(kc - 1, -1, -1):
        u = hier.transfers[k].prolong(u)
        for _ in range(nu0):
            u = vcycle_topo(hier, u, bs[k], nu1=nu1, nu2=nu2,
                            omega=omega, k=k)
    return u


def solve_topo(hier: TopoHierarchy, b, *, num_cycles: int = 20,
               nu1: int = 3, nu2: int = 3,
               omega: Union[float, Tuple[float, ...]] = 2.0 / 3.0,
               use_fmg: bool = False, u0=None, mesh=None,
               prefer_structured: bool = False):
    """Fixed-count driver with residual history (the observability the
    reference lacks).  Returns ``(u, res_history)``; jit-compatible.

    ``mesh=``: distribute over a device mesh via 1D DOF-row GSPMD
    partitioning (``dist.topo.gspmd_solve_topo`` — padded levels, zero
    pad-slot invariant); covers structured-permuted, trimesh and tetmesh
    hierarchies alike.

    ``prefer_structured=True``: if the hierarchy was built by
    ``build_structured_topo_hierarchy_sparse`` (which records its
    structure on the object), route through :func:`solve_permuted` —
    the numbering is factored out once per solve and the cycles run the
    structured path (whether it still beats the ELL gathers on the GPU is
    unmeasured, ROADMAP).  Falls back to the general tier when no
    structure metadata is present (e.g. after ``jax.device_put``, whose
    pytree round-trip drops plain attributes) or when ``u0``/``use_fmg``
    /``mesh`` ask for general-tier semantics."""
    struct = getattr(hier, "perm_structure", None)
    if (prefer_structured and struct is not None and mesh is None
            and u0 is None and not use_fmg):
        from .config import MultigridConfig
        finest, coarsest, perm0 = struct
        coarsest = min(coarsest, finest - 1)
        # Structured-path semantics: keep the sweep counts, take the
        # structured solver's tuned omega (0.8) rather than the ELL
        # tier's 2/3 default.
        cfg = MultigridConfig(
            finest_level=finest, coarsest_level=coarsest,
            smoother="jacobi", nu1=nu1, nu2=nu2, dtype=b.dtype)
        return solve_permuted(finest, b, perm0,
                              coarsest_level=coarsest,
                              num_cycles=num_cycles, config=cfg)
    if mesh is not None:
        from .dist.topo import gspmd_solve_topo
        return gspmd_solve_topo(hier, b, mesh, num_cycles=num_cycles,
                                nu1=nu1, nu2=nu2, omega=omega,
                                use_fmg=use_fmg, u0=u0)
    op = hier.ops[0]
    if u0 is not None:
        u = u0
    elif use_fmg:
        u = fmg_topo(hier, nu0=1, nu1=nu1, nu2=nu2, omega=omega,
                     dtype=b.dtype)
    else:
        u = jnp.zeros((op.m,), b.dtype)
    hist = jnp.zeros((num_cycles + 1,), jnp.float32)
    hist = hist.at[0].set(
        jnp.linalg.norm(op.residual(u, b).astype(jnp.float32)))

    def body(i, carry):
        u, hist = carry
        u = vcycle_topo(hier, u, b, nu1=nu1, nu2=nu2, omega=omega)
        r = jnp.linalg.norm(op.residual(u, b).astype(jnp.float32))
        return u, hist.at[i + 1].set(r)

    u, hist = jax.lax.fori_loop(0, num_cycles, body, (u, hist))
    return u, hist


def solve_permuted(finest_level: int, b, perm: Optional[np.ndarray] = None,
                   *, coarsest_level: int = 5, num_cycles: int = 20,
                   config=None):
    """Structured route for permuted-structured topologies.

    The v2 ``ProblemVar`` metadata (``Multigrid_functions.cpp:98-130``)
    records, for every DOF, *where it sits on the grid* — so whenever a
    topology is a renumbered structured grid the numbering is known and
    invertible.  The general ELL tier pays a gather on EVERY stencil
    application.  This route instead factors the operator as
    ``A_topo = P A Pᵀ`` and pays the permutation exactly twice per solve:
    ``b_struct = Pᵀ b`` at entry and ``u_topo = P u`` at exit — two O(m)
    gathers amortized over the whole solve, with every cycle in between
    on the structured path.

    ``b`` is a space vector in the *topo* numbering (``b[perm[k]]`` is
    the RHS of row-major interior node ``k``); ``perm=None`` means
    row-major already.  Returns ``(u_topo, res_history)`` like
    :func:`solve_topo`.
    """
    from .config import MultigridConfig
    from .problems.poisson import PoissonProblem
    from .cycles import solve_fixed

    n = 2 ** finest_level
    m = (n - 1) ** 2
    if b.shape != (m,):
        raise ValueError(f"b must be a space vector of shape ({m},)")
    coarsest_level = min(coarsest_level, finest_level - 1)
    cfg = config or MultigridConfig(
        finest_level=finest_level, coarsest_level=coarsest_level,
        smoother="jacobi", nu1=3, nu2=3, dtype=b.dtype)
    prob = PoissonProblem(cfg)
    hier = prob.hierarchy
    op0 = hier.levels[0]
    S = getattr(op0, "grid_shape", (op0.S, op0.S))
    if not isinstance(S, tuple):
        S = (S, S)

    if perm is not None:
        p = jnp.asarray(np.asarray(perm, np.int64), jnp.int32)
        b_vec = b[p]
    else:
        b_vec = b
    b_grid = jnp.zeros(S, b.dtype).at[1:n, 1:n].set(
        b_vec.reshape(n - 1, n - 1))
    res = solve_fixed(hier, cfg, b_grid, num_cycles)
    u_int = res.u[1:n, 1:n].reshape(m)
    if perm is not None:
        u_topo = jnp.zeros((m,), u_int.dtype).at[p].set(u_int)
    else:
        u_topo = u_int
    return u_topo, res.res_history


# ---------------------------------------------------------------------------
# Structured-mesh builder (the canonical instance)
# ---------------------------------------------------------------------------

def build_structured_topo_hierarchy(
    finest_level: int, coarsest_level: int = 2,
    f: Union[float, Callable] = 4.0,
    perms: Optional[Sequence[Optional[np.ndarray]]] = None,
    restrict_scale: float = 4.0,
    dtype=jnp.float32,
) -> TopoHierarchy:
    """Assemble a general-DOF hierarchy for the unit-square criss-cross mesh.

    Per-level operators and load vectors come from true element assembly
    (``core.fem.assemble_from_elements`` — the reference's
    ``globalstiffenssmatrix``/``globalforcefunction`` algorithm done
    float-correct), i.e. the v2 "re-assembled per level" semantics rather
    than Galerkin products.  ``perms[k]`` optionally renumbers level k's
    space dofs (exercising ``topo_to_space_dict`` generality).
    """
    from .core.fem import assemble_from_elements

    levels = list(range(finest_level, coarsest_level - 1, -1))
    if perms is None:
        perms = [None] * len(levels)
    ops_, bs = [], []
    for lvl, perm in zip(levels, perms):
        n = 2 ** lvl
        A, b = assemble_from_elements(n, f)
        if perm is not None:
            p = np.asarray(perm)
            m = A.shape[0]
            Ap = np.zeros_like(A)
            Ap[np.ix_(p, p)] = A
            bp = np.zeros_like(b)
            bp[p] = b
            A, b = Ap, bp
        ops_.append(ell_from_dense(A))
        bs.append(jnp.asarray(b, dtype))
    transfers = tuple(
        structured_transfer(2 ** lvl, perm_f=pf, perm_c=pc,
                            restrict_scale=restrict_scale)
        for lvl, pf, pc in zip(levels[:-1], perms[:-1], perms[1:]))
    n_c = 2 ** coarsest_level
    A_c, _ = assemble_from_elements(n_c, f)
    if perms[-1] is not None:
        p = np.asarray(perms[-1])
        Ap = np.zeros_like(A_c)
        Ap[np.ix_(p, p)] = A_c
        A_c = Ap
    coarse_inv = jnp.asarray(np.linalg.inv(A_c), dtype)
    return TopoHierarchy(tuple(ops_), transfers, coarse_inv, tuple(bs))


# ---------------------------------------------------------------------------
# Scalable structured builder (vectorized; production sizes)
# ---------------------------------------------------------------------------

def _cnode_space(a, b, nc, perm_c, mc):
    """Vectorized coarse node (a, b) -> space dof (or the zero slot mc)."""
    interior = (a >= 1) & (a <= nc - 1) & (b >= 1) & (b <= nc - 1)
    k = (np.clip(a, 1, nc - 1) - 1) * (nc - 1) + (np.clip(b, 1, nc - 1) - 1)
    s = k if perm_c is None else perm_c[k]
    return np.where(interior, s, mc).astype(np.int32)


def structured_transfer_fast(nf: int, perm_f: Optional[np.ndarray] = None,
                             perm_c: Optional[np.ndarray] = None,
                             restrict_scale: float = 4.0) -> TopoTransfer:
    """Vectorized twin of :func:`structured_transfer` (same tables, no
    Python dict loops — production sizes; parity-tested against the
    metadata path).  The parent cases follow ``structured_metadata``:
    even-even fine nodes coincide with coarse vertices; odd-even /
    even-odd sit on vertical / horizontal coarse edges; odd-odd on the
    criss-cross diagonal from (i//2+1, j//2) to (i//2, j//2+1)."""
    nc = nf // 2
    if nc < 1 or nf % 2:
        raise ValueError("nf must be even and >= 2")
    mf, mc = (nf - 1) ** 2, (nc - 1) ** 2
    pf = None if perm_f is None else np.asarray(perm_f, np.int64)
    pc = None if perm_c is None else np.asarray(perm_c, np.int64)

    i, j = np.meshgrid(np.arange(1, nf), np.arange(1, nf), indexing="ij")
    fs = (i - 1) * (nf - 1) + (j - 1)
    if pf is not None:
        fs = pf[fs]
    ei, ej = i % 2 == 0, j % 2 == 0
    # endpoint 0: even-even/odd-even/even-odd -> (i//2, j//2); odd-odd
    # -> (i//2 + 1, j//2)
    a0 = np.where(~ei & ~ej, i // 2 + 1, i // 2)
    b0 = j // 2
    # endpoint 1: even-even -> same vertex; odd-even -> (i//2+1, j//2);
    # even-odd / odd-odd -> (i//2, j//2+1)
    a1 = np.where(~ei & ej, i // 2 + 1, i // 2)
    b1 = np.where(ej, j // 2, j // 2 + 1)
    s0 = _cnode_space(a0, b0, nc, pc, mc)
    s1 = _cnode_space(a1, b1, nc, pc, mc)
    src0 = np.full(mf, mc, np.int32)
    src1 = np.full(mf, mc, np.int32)
    src0[fs.ravel()] = s0.ravel()
    src1[fs.ravel()] = s1.ravel()

    ic, jc = np.meshgrid(np.arange(1, nc), np.arange(1, nc), indexing="ij")
    cs = (ic - 1) * (nc - 1) + (jc - 1)
    if pc is not None:
        cs = pc[cs]
    fk = (2 * ic - 1) * (nf - 1) + (2 * jc - 1)
    if pf is not None:
        fk = pf[fk]
    inj = np.zeros(mc, np.int32)
    inj[cs.ravel()] = fk.ravel().astype(np.int32)

    return TopoTransfer(jnp.asarray(src0), jnp.asarray(src1),
                        jnp.asarray(inj), restrict_scale)


def _stencil5_coo(n: int, perm: Optional[np.ndarray]):
    """COO triplets of the interior 5-point FEM stencil (h-independent
    [[-0,-1,0],[-1,4,-1],[0,-1,0]]) on the unit square, space dofs
    row-major (optionally renumbered by ``perm``).  Matches
    ``assemble_from_elements`` exactly on the criss-cross mesh (the
    diagonal couplings cancel) — vectorized for production sizes."""
    m = (n - 1) ** 2
    i, j = np.meshgrid(np.arange(1, n), np.arange(1, n), indexing="ij")
    k = ((i - 1) * (n - 1) + (j - 1)).ravel()
    p = np.arange(m, dtype=np.int64) if perm is None \
        else np.asarray(perm, np.int64)
    rows = [p[k]]
    cols = [p[k]]
    vals = [np.full(m, 4.0)]
    for di, dj in ((-1, 0), (1, 0), (0, -1), (0, 1)):
        ni, nj = i + di, j + dj
        mask = ((ni >= 1) & (ni <= n - 1) & (nj >= 1)
                & (nj <= n - 1)).ravel()
        kn = ((np.clip(ni, 1, n - 1) - 1) * (n - 1)
              + (np.clip(nj, 1, n - 1) - 1)).ravel()
        rows.append(p[k[mask]])
        cols.append(p[kn[mask]])
        vals.append(np.full(mask.sum(), -1.0))
    return (np.concatenate(rows), np.concatenate(cols),
            np.concatenate(vals))


def build_structured_topo_hierarchy_sparse(
    finest_level: int, coarsest_level: int = 5,
    f: Union[float, Callable] = 4.0,
    perms: Optional[Sequence[Optional[np.ndarray]]] = None,
    restrict_scale: float = 4.0,
    dtype=jnp.float32,
) -> TopoHierarchy:
    """Production-size twin of :func:`build_structured_topo_hierarchy`.

    Same hierarchy semantics (re-assembled per level, optional per-level
    DOF permutations, dense coarsest inverse) built from vectorized COO
    assembly + :func:`structured_transfer_fast` instead of dense element
    loops — O(m) setup, so 1025²+ finest levels are reachable.  RHS is
    the vectorized ``f h²`` load (``problems.poisson.poisson_rhs``
    semantics on space vectors)."""
    levels = list(range(finest_level, coarsest_level - 1, -1))
    if perms is None:
        perms = [None] * len(levels)
    ops_, bs = [], []
    for lvl, perm in zip(levels, perms):
        n = 2 ** lvl
        m = (n - 1) ** 2
        r, c, v = _stencil5_coo(n, perm)
        ops_.append(ell_from_coo(r, c, v, m))
        # Vectorized f·h² load (nodal quadrature; identical to the
        # element-assembled load for constant f, O(h²)-equivalent for
        # callable f evaluated at nodes instead of centroids).
        h = 1.0 / n
        i, j = np.meshgrid(np.arange(1, n), np.arange(1, n),
                           indexing="ij")
        fv = (np.full(m, float(f)) if not callable(f)
              else np.asarray(f(j.ravel() * h, i.ravel() * h),
                              np.float64).ravel())
        b = np.zeros(m)
        k = ((i - 1) * (n - 1) + (j - 1)).ravel()
        p = np.arange(m, dtype=np.int64) if perm is None \
            else np.asarray(perm, np.int64)
        b[p[k]] = fv * h * h
        bs.append(jnp.asarray(b, dtype))
    transfers = tuple(
        structured_transfer_fast(2 ** lvl, perm_f=pf, perm_c=pc,
                                 restrict_scale=restrict_scale)
        for lvl, pf, pc in zip(levels[:-1], perms[:-1], perms[1:]))
    n_c = 2 ** coarsest_level
    m_c = (n_c - 1) ** 2
    r, c, v = _stencil5_coo(n_c, perms[-1])
    A_c = np.zeros((m_c, m_c))
    A_c[r, c] = v
    coarse_inv = jnp.asarray(np.linalg.inv(A_c), dtype)
    th = TopoHierarchy(tuple(ops_), transfers, coarse_inv, tuple(bs))
    # Structure metadata for solve_topo(prefer_structured=True) /
    # solve_permuted — a plain attribute, deliberately OUTSIDE the
    # pytree (dropped by device_put/jit round-trips; the routing
    # degrades gracefully to the general tier).
    th.perm_structure = (finest_level, coarsest_level,
                         None if perms[0] is None
                         else np.asarray(perms[0], np.int64))
    return th
