"""Test harness: force CPU with 8 virtual devices and enable f64.

SURVEY.md §4 tier 4: multi-device behavior is exercised with
``xla_force_host_platform_device_count`` so halo exchange and sharding run
without accelerators.  f64 gives oracle-grade comparisons (1e-10 rel L2).

``TMG_TEST_PLATFORM=gpu`` leaves the platform to JAX instead, for the
tests marked ``gpu`` on a machine with an NVIDIA GPU:

    TMG_TEST_PLATFORM=gpu python -m pytest tests/ -m gpu
"""

import os

ON_GPU = os.environ.get("TMG_TEST_PLATFORM") == "gpu"
if not ON_GPU:
    os.environ["JAX_PLATFORMS"] = "cpu"
    xla_flags = os.environ.get("XLA_FLAGS", "")
    if "xla_force_host_platform_device_count" not in xla_flags:
        os.environ["XLA_FLAGS"] = (
            xla_flags + " --xla_force_host_platform_device_count=8").strip()

import jax

if not ON_GPU:
    jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)

import numpy as np
import pytest


@pytest.fixture
def rng():
    return np.random.default_rng(0)


@pytest.fixture
def gpu():
    """Skip unless JAX's backend is an NVIDIA GPU (decided per test, never
    at import, so every xdist worker collects the same tests)."""
    if jax.default_backend() != "gpu":
        pytest.skip("needs an NVIDIA GPU (TMG_TEST_PLATFORM=gpu on the card)")


@pytest.fixture(autouse=True, scope="module")
def _clear_jax_caches_per_module():
    """Bound in-process XLA/LLVM state accumulation.

    The XLA:CPU compiler intermittently SEGFAULTS late in the full suite
    (~15 min of accumulated jit executables; observed repeatedly in
    backend_compile_and_load compiling var-stencil smoother loops in the
    alphabetically-last test module, each time at a different test).
    Dropping compiled programs between modules keeps the process state
    small; per-module recompiles of shared ops cost seconds.
    """
    yield
    import jax

    jax.clear_caches()


# ---------------------------------------------------------------------------
# Slow tier: the heaviest tests — measured >= 11 s on a single CPU core
# with --durations — are deselected by default so the core suite stays
# under ~5 min anywhere.  pytest prints the
# deselection count; run EVERYTHING with
#     python -m pytest tests/ -q -m "slow or not slow"
# (the full suite remains the pre-commit bar; see CLAUDE.md).  Every module
# keeps fast tests in the core tier, so quick runs still touch all
# subsystems.  New heavyweight tests should be added to this list.
# ---------------------------------------------------------------------------

_SLOW_TESTS = frozenset([
    # r3 session-2 additions (>= ~15 s each on this host)
    "test_convection.py::TestAccuracy::test_manufactured_o_h",
    "test_convection.py::TestConvergence::test_rbgs_h_independent[0.01]",
    "test_convection.py::TestConvergence::test_rbgs_h_independent[0.0025]",
    "test_krylov.py::test_bicgstab_nonsymmetric_convection",
    "test_semicoarsen.py::TestConvergence::test_zebra_on_semi_hierarchy",
    "test_semicoarsen.py::TestConvergence::test_point_smoother_h_independent[1000.0]",
    # r3 additions (>= ~15 s each on this host)
    "test_anisotropic.py::TestSolve::test_isotropic_zebra_still_works",
    "test_anisotropic.py::TestSolve::test_matches_dense_solve",
    "test_anisotropic.py::TestSolve::test_point_smoother_stalls_zebra_does_not",
    "test_anisotropic.py::TestSolve::test_transposed_anisotropy_uses_zebra_y",
    "test_anisotropic.py::TestSolve::test_zebra_mesh_independent",
    "test_cycles.py::test_fmg_until_tol_with_history",
    "test_diffusion3d.py::test_convergence_mesh_independent_with_contrast",
    "test_diffusion3d.py::test_manufactured_solution_order",
    "test_dist_var.py::test_sharded_fmg_matches_global_fmg",
    "test_dist_var.py::test_sharded_fmg_matches_single_device[None]",
    "test_dist_var.py::test_sharded_fmg_matches_single_device[_jump]",
    "test_dist_var.py::test_sharded_u0_resume",
    "test_dist_var.py::test_sharded_var_solve_converges",
    "test_dist_var.py::test_sharded_var_solve_matches_single_device[mesh_shape0]",
    "test_dist_var.py::test_sharded_var_solve_matches_single_device[mesh_shape1]",
    "test_graft_entry.py::test_dryrun_multichip_green[8]",
    "test_helmholtz.py::test_api_entry",
    "test_helmholtz.py::test_convergence_mesh_independent_and_at_least_poisson_fast",
    "test_helmholtz.py::test_manufactured_solution_order",
    "test_helmholtz.py::test_variable_and_negative_shift",
    "test_krylov.py::test_pcg_converges_faster_than_plain_cycles",
    "test_krylov.py::test_pcg_robust_on_hard_coefficients",
    "test_mixedbc.py::TestSolve::test_convergence_mesh_independent[neumann0]",
    "test_mixedbc.py::TestSolve::test_convergence_mesh_independent[neumann1]",
    "test_mixedbc.py::TestSolve::test_convergence_mesh_independent[neumann2]",
    "test_mixedbc.py::TestSolve::test_fmg_mixed",
    "test_mixedbc.py::TestSolve::test_manufactured_homogeneous_neumann_order",
    "test_mixedbc.py::TestSolve::test_manufactured_inhomogeneous_neumann_exact",
    "test_oracle_parity.py::test_diffusion_discontinuous_coefficient_converges",
    "test_oracle_parity.py::test_diffusion_matches_oracle",
    "test_oracle_parity.py::test_manufactured_solution_discretization_order",
    "test_oracle_parity.py::test_poisson_larger_grids_match_oracle[7]",
    "test_oracle_parity.py::test_reference_fmg_schedule_parity",
    "test_poisson3d.py::TestSolve3d::test_api_entry",
    "test_poisson3d.py::TestSolve3d::test_convergence_mesh_independent",
    "test_poisson3d.py::TestSolve3d::test_fmg_reaches_discretization_accuracy",
    "test_poisson3d.py::TestSolve3d::test_manufactured_solution_order",
    "test_poisson3d.py::TestSolve3d::test_padded_levels",
    "test_poisson3d.py::TestSolve3d::test_vcycle_convergence_factor",
    "test_precision.py::test_bf16_inner_cycle_smoke",
    "test_precision.py::test_cycle_ds_matches_plain_refined",
    "test_precision.py::test_ds_residual3_matches_f64",
    "test_precision.py::test_refined3_api_entry",
    "test_precision.py::test_refined3_breaks_the_f32_floor",
    "test_precision.py::test_refined3_ts_matches_f64_oracle",
    "test_precision.py::test_refined_api_honors_fmg_and_num_cycles",
    "test_precision.py::test_refined_checkpoint_roundtrip_preserves_trajectory",
    "test_precision.py::test_refined_solve_breaks_the_f32_floor",
    "test_precision.py::test_ts_refinement_reaches_deeper_than_ds",
    "test_trimesh.py::TestSolve::test_h_independent_rate_lshape",
    "test_utils.py::test_checkpoint_roundtrip_and_resume",
    # Every test measured >= 9 s in a full-durations core run on one CPU
    # core.  Coverage is unchanged in the full tier (pre-commit bar for
    # kernel/cycle changes).
    "test_anisotropic.py::TestRotated::test_45deg_usable_rate[rbgs-nu1]",
    "test_anisotropic.py::TestRotated::test_45deg_usable_rate[zebra_x-nu0]",
    "test_anisotropic.py::TestRotated::test_o_h2_manufactured_rotated",
    "test_anisotropic.py::TestRotated::test_pcg_wraps_hard_rotation",
    "test_convection3d.py::TestAccuracy::test_manufactured_o_h",
    "test_convection3d.py::TestConvergence::test_rbgs_h_independent[0.005]",
    "test_convection3d.py::TestConvergence::test_rbgs_h_independent[0.02]",
    "test_cycles.py::test_cycle_count_grid_independent",
    "test_diffusion3d.py::TestReactionShift3D::test_manufactured_o_h2",
    "test_diffusion3d.py::test_api_entry",
    "test_dist_operator.py::TestAPI::test_distributed_family_solves_converge",
    "test_dist_operator.py::TestZebraLines::test_zebra_api_rowband_mesh",
    "test_dist_operator.py::TestZebraLines::test_zebra_x_1_vs_4_rowband",
    "test_dist_operator.py::TestZebraLines::test_zebra_y_1_vs_4_colband",
    "test_dist_var.py::test_api_mesh_matches_single_device_f64",
    "test_dist_var.py::test_api_mesh_routes_to_sharded",
    "test_dist_var.py::test_local_var_ops_match_global[mesh_shape0]",
    "test_dist_var3.py::test_convergence_2x4",
    "test_dist_var3.py::test_local_var3_ops_match_global[mesh_shape0]",
    "test_dist_var3.py::test_matches_single_chip_problem",
    "test_dist_var3.py::test_parity_2x2_vs_1x1",
    "test_eigen.py::test_poisson3d_ground_state",
    "test_eigen.py::test_unit_square_ground_state_o_h2",
    "test_fas.py::test_bratu_manufactured_solution_order",
    "test_fas.py::test_fas_reduces_to_linear_cycle[F]",
    "test_fas.py::test_fas_reduces_to_linear_cycle[V]",
    "test_fas.py::test_fas_reduces_to_linear_cycle[W]",
    "test_galerkin.py::test_host_rap_matches_probing_exactly",
    "test_krylov.py::test_pcg_poisson_matches_oracle",
    "test_mixedbc3d.py::test_convergence_factor_bounded[neumann0]",
    "test_mixedbc3d.py::test_convergence_factor_bounded[neumann1]",
    "test_mixedbc3d.py::test_manufactured_homogeneous_neumann_order",
    "test_mixedbc3d.py::test_manufactured_inhomogeneous_neumann_exact",
    "test_periodic.py::TestSolve::test_mesh_independent_rho",
    "test_periodic3d.py::TestSolve::test_mesh_independent_rho_deep_hierarchy",
    "test_poisson3d.py::TestBoundaryLifting3D::test_constant_boundary_all_families",
    "test_poisson3d.py::TestSolve3d::test_matches_dense_solve",
    "test_poisson3d.py::TestSolve3d::test_w_cycle_and_chebyshev",
    "test_poisson4.py::TestAccuracy::test_o_h4_vs_o_h2",
    "test_poisson4.py::TestConvergence::test_mesh_independent[chebyshev-nu0]",
    "test_poisson4.py::TestConvergence::test_mesh_independent[rbgs-nu1]",
    "test_poisson4_3d.py::TestSolve::test_mesh_independent_rho",
    "test_poisson4_3d.py::TestSolve::test_o_h4_via_api",
    "test_semicoarsen.py::TestAccuracy::test_manufactured_o_h2",
    "test_semicoarsen.py::TestConvergence::test_beats_full_coarsening_point_smoother",
    "test_semicoarsen.py::TestConvergence::test_fmg_start",
    "test_semicoarsen.py::TestConvergence::test_point_smoother_h_independent[100.0]",
    "test_semicoarsen3.py::TestAPI::test_manufactured_solution_o_h2",
    "test_semicoarsen3.py::TestAPI::test_solve_converges_all_axes",
    "test_semicoarsen3.py::TestRobustness::test_h_independent_rate",
    "test_semicoarsen3.py::TestRobustness::test_semi_beats_full_at_strong_anisotropy",
    "test_tetmesh.py::TestSolve::test_direct_o_h2_convergence",
    "test_tetmesh.py::TestSolve::test_h_independent_rate_fichera",
    "test_utils.py::test_debug_guards_3d",
    "test_utils.py::test_sharded_checkpoint_roundtrip_and_resume",
])


def pytest_collection_modifyitems(config, items):
    for item in items:
        nodeid = item.nodeid
        if nodeid.startswith("tests/"):
            nodeid = nodeid[len("tests/"):]
        if nodeid in _SLOW_TESTS:
            item.add_marker(pytest.mark.slow)
