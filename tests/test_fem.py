"""Element-level FEM utilities (SURVEY.md §2 items #6/#7) and the
element-assembly oracle vs the closed-form stencil."""

import numpy as np
import pytest

from tpu_multigrid.core import fem
from tpu_multigrid import oracle


def test_triangle_stiffness_reference_triangle():
    # Unit right triangle (0,0),(1,0),(0,1): the classic K
    k = fem.triangle_stiffness([[0, 0], [1, 0], [0, 1]])
    want = np.array([[1.0, -0.5, -0.5], [-0.5, 0.5, 0.0], [-0.5, 0.0, 0.5]])
    np.testing.assert_allclose(k, want, atol=1e-14)
    # Row sums vanish (constants are in the kernel of the stiffness).
    np.testing.assert_allclose(k.sum(axis=1), 0.0, atol=1e-14)


def test_triangle_stiffness_scale_invariance():
    # P1 stiffness of the Laplacian is scale-invariant in 2D.
    k1 = fem.triangle_stiffness([[0, 0], [1, 0], [0, 1]])
    k2 = fem.triangle_stiffness([[0, 0], [0.125, 0], [0, 0.125]])
    np.testing.assert_allclose(k1, k2, atol=1e-14)


def test_triangle_load():
    fe = fem.triangle_load([[0, 0], [1, 0], [0, 1]], 6.0)
    np.testing.assert_allclose(fe, 1.0)  # area 1/2, f*|T|/3 = 1


def test_degenerate_triangle_raises():
    with pytest.raises(ValueError):
        fem.triangle_stiffness([[0, 0], [1, 1], [2, 2]])


@pytest.mark.parametrize("n", [4, 8, 16])
def test_element_assembly_matches_stencil(n):
    """Element-by-element assembly == the closed-form 5-point stencil the
    matrix-free device path uses (validates SURVEY §7's 'the stiffness IS the
    stencil' premise)."""
    A, b = fem.assemble_from_elements(n, f=4.0)
    want = oracle.poisson_matrix(n).toarray()
    np.testing.assert_allclose(A, want, atol=1e-12)
    # Load vector: 6 triangles of area h^2/2 around each interior node,
    # each contributing f*|T|/3 -> b = f*h^2.
    np.testing.assert_allclose(b, 4.0 / n**2, rtol=1e-12)


def test_element_assembly_variable_forcing():
    n = 8
    f = lambda x, y: 1.0 + x + 2 * y
    A, b = fem.assemble_from_elements(n, f=f)
    assert b.min() > 0 and not np.allclose(b, b[0])
