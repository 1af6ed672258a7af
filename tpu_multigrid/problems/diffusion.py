"""Variable-coefficient diffusion -div(a(x) grad u) = f (BASELINE config 4).

An extension over the reference (which supports constant coefficients only):
per-cell coefficient arrays define the fine 5-point flux stencil, and coarse
operators are built by Galerkin coarsening R A P at setup time
(``core.operators.galerkin_coarsen``), stored as 9-point
stencil-coefficient arrays.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Union

import jax.numpy as jnp

from ..config import MultigridConfig
from ..core.grids import Hierarchy, build_galerkin_hierarchy, level_sizes
from ..core.operators import diffusion_op
from .poisson import poisson_rhs


def cell_coefficients(n: int, a: Union[float, Callable],
                      dtype=jnp.float32) -> jnp.ndarray:
    """(n, n) per-cell coefficients; callable ``a(x, y)`` sampled at centers."""
    if callable(a):
        h = 1.0 / n
        c = (jnp.arange(n, dtype=dtype) + 0.5) * h
        x = jnp.broadcast_to(c[None, :], (n, n))
        y = jnp.broadcast_to(c[:, None], (n, n))
        return a(x, y).astype(dtype)
    return jnp.full((n, n), float(a), dtype)


@dataclasses.dataclass
class DiffusionProblem:
    """Variable-coefficient diffusion with Galerkin-coarsened hierarchy."""

    config: MultigridConfig
    coefficient: Union[float, Callable] = 1.0
    forcing: Union[float, Callable] = 4.0
    align: int = 1
    min_pad_level: int = 99

    def __post_init__(self):
        import jax
        import numpy as np

        from ..core.operators import diffusion_op_host

        sizes = level_sizes(self.config, align=self.align,
                            min_pad_level=self.min_pad_level)
        n0, S0 = sizes[0]
        # Evaluate the coefficient callable on the host CPU backend and
        # build the whole hierarchy in host memory, with no device->host
        # readback during setup.  jit uploads the finished hierarchy once
        # at the first solve.
        try:
            cpu = jax.devices("cpu")[0]
            with jax.default_device(cpu):
                cells = np.asarray(
                    cell_coefficients(n0, self.coefficient,
                                      self.config.dtype))
        except Exception:
            cells = np.asarray(
                cell_coefficients(n0, self.coefficient, self.config.dtype))
        fine_op = diffusion_op_host(cells, n0, S0)
        hier = build_galerkin_hierarchy(
            fine_op, self.config, align=self.align,
            min_pad_level=self.min_pad_level)
        # Upload the finished hierarchy ONCE: numpy leaves passed as jit
        # arguments would otherwise be re-transferred on every call.
        self.hierarchy: Hierarchy = jax.device_put(hier)

    @property
    def finest(self):
        return self.hierarchy.levels[0]

    def rhs(self, level_index: int = 0, dtype=None) -> jnp.ndarray:
        op = self.hierarchy.levels[level_index]
        dt = dtype if dtype is not None else self.config.dtype
        return poisson_rhs(op.n, op.S, self.forcing, dt)
