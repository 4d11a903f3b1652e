import jax.numpy as jnp
import numpy as np
import pytest
import scipy.fft

from hipace_tpu.ops.dst import dst1, dst1_2d
from hipace_tpu.fields.poisson import DirichletPoissonSolver, PeriodicPoissonSolver
from hipace_tpu.fields.multigrid import MultiGrid


def test_dst1_matches_scipy():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((3, 17))
    ours = np.asarray(dst1(jnp.asarray(x), axis=-1))
    ref = scipy.fft.dst(x, type=1, axis=-1) / 2.0  # scipy is 2x the sine sum
    np.testing.assert_allclose(ours, ref, rtol=1e-10, atol=1e-12)


def test_dst1_2d_involution():
    rng = np.random.default_rng(1)
    x = rng.standard_normal((15, 31))
    twice = np.asarray(dst1_2d(dst1_2d(jnp.asarray(x))))
    np.testing.assert_allclose(twice, x * (16 * 32) / 4, rtol=1e-10)


def _fd_laplacian_dirichlet(u, dx, dy):
    """5-point Laplacian with u=0 at ghost nodes."""
    up = np.pad(u, 1)
    return ((up[1:-1, :-2] - 2 * u + up[1:-1, 2:]) / dx**2
            + (up[:-2, 1:-1] - 2 * u + up[2:, 1:-1]) / dy**2)


@pytest.mark.parametrize("shape", [(31, 31), (16, 32), (15, 31)])
def test_dirichlet_poisson(shape):
    ny, nx = shape
    dx, dy = 0.1, 0.2
    rng = np.random.default_rng(2)
    rhs = rng.standard_normal((ny, nx))
    solver = DirichletPoissonSolver(nx, ny, dx, dy, dtype=jnp.float64)
    u = np.asarray(solver.solve(jnp.asarray(rhs)))
    np.testing.assert_allclose(_fd_laplacian_dirichlet(u, dx, dy), rhs,
                               rtol=1e-8, atol=1e-8)


def test_dirichlet_poisson_batched():
    ny, nx = 24, 16
    rng = np.random.default_rng(3)
    rhs = rng.standard_normal((3, ny, nx))
    solver = DirichletPoissonSolver(nx, ny, 0.5, 0.5, dtype=jnp.float64)
    u = np.asarray(solver.solve(jnp.asarray(rhs)))
    for b in range(3):
        np.testing.assert_allclose(
            _fd_laplacian_dirichlet(u[b], 0.5, 0.5), rhs[b], rtol=1e-8, atol=1e-8)


@pytest.mark.parametrize("dtype,tol", [(jnp.float64, 1e-10),
                                       (jnp.float32, 5e-5)],
                         ids=["f64", "f32"])
def test_dirichlet_poisson_fast_matches_expanded(dtype, tol):
    """The reference's FFTDirichletFast variant (same-size rfft with sine
    twiddles) against the f64 odd-extension solve, 3-channel batched as in
    the Psi/Ez/Bz solve. The f32 bound is the f32 FFT roundoff envelope."""
    ny = nx = 127
    dx, dy = 0.1, 0.1
    rng = np.random.default_rng(7)
    rhs = rng.standard_normal((3, ny, nx))
    ref = DirichletPoissonSolver(nx, ny, dx, dy, dtype=jnp.float64,
                                 variant="expanded").solve(jnp.asarray(rhs))
    fast = DirichletPoissonSolver(nx, ny, dx, dy, dtype=dtype,
                                  variant="fast")
    u = fast.solve(jnp.asarray(rhs, dtype))
    err = float(jnp.max(jnp.abs(u - ref)) / jnp.max(jnp.abs(ref)))
    assert err < tol, err


@pytest.mark.parametrize("ny,nx,nchan", [(31, 31, 2), (63, 31, 1),
                                         (15, 127, 2)])
def test_multigrid_matches_dst(ny, nx, nchan):
    """acf = 0: the V-cycle solve converges to the DST solution (both use
    the ghost-node Dirichlet convention on odd grids)."""
    rng = np.random.default_rng(ny + nx + nchan)
    rhs = jnp.asarray(rng.standard_normal((nchan, ny, nx)))
    mg = MultiGrid(nx, ny, 0.05, 0.07, jnp.float64)
    u = mg.solve(jnp.zeros_like(rhs), rhs, 0.0, tol_rel=1e-11,
                 max_iters=100)
    ref = DirichletPoissonSolver(nx, ny, 0.05, 0.07,
                                 dtype=jnp.float64).solve(rhs)
    np.testing.assert_allclose(np.asarray(u), np.asarray(ref), rtol=1e-7,
                               atol=1e-9 * float(jnp.max(jnp.abs(ref))))


def test_multigrid_constant_acf_matches_helmholtz():
    """Constant a-coefficient: MG solve of Lap(u) - a u = rhs against the
    spectral Helmholtz solve."""
    ny = nx = 31
    rng = np.random.default_rng(11)
    rhs = jnp.asarray(rng.standard_normal((ny, nx)))
    mg = MultiGrid(nx, ny, 0.1, 0.1, jnp.float64)
    u = mg.solve(jnp.zeros_like(rhs), rhs, 2.5, tol_rel=1e-11,
                 max_iters=100)
    ref = DirichletPoissonSolver(nx, ny, 0.1, 0.1,
                                 dtype=jnp.float64).solve_helmholtz(rhs, 2.5)
    np.testing.assert_allclose(np.asarray(u), np.asarray(ref), rtol=1e-7,
                               atol=1e-9 * float(jnp.max(jnp.abs(ref))))


def test_multigrid_solve_info_counts_vcycles():
    """solve_info returns solve()'s answer and the V-cycle count: tighter
    tolerances take more cycles, and the count stops at max_iters."""
    ny = nx = 63
    rng = np.random.default_rng(5)
    rhs = jnp.asarray(rng.standard_normal((2, ny, nx)))
    acf = jnp.asarray(np.abs(rng.standard_normal((ny, nx))))
    mg = MultiGrid(nx, ny, 0.05, 0.05, jnp.float64)
    u0 = jnp.zeros_like(rhs)
    u, n_loose = mg.solve_info(u0, rhs, acf, tol_rel=1e-4)
    np.testing.assert_array_equal(np.asarray(u),
                                  np.asarray(mg.solve(u0, rhs, acf)))
    _, n_tight = mg.solve_info(u0, rhs, acf, tol_rel=1e-10)
    _, n_cap = mg.solve_info(u0, rhs, acf, tol_rel=1e-14, max_iters=3)
    assert 1 <= int(n_loose) < int(n_tight) <= 40
    assert int(n_cap) == 3


def test_periodic_poisson():
    ny, nx = 32, 32
    dx = dy = 0.3
    x = np.arange(nx) * dx
    y = np.arange(ny) * dy
    kx = 2 * np.pi / (nx * dx) * 3
    ky = 2 * np.pi / (ny * dy) * 2
    rhs = np.cos(kx * x[None, :] + ky * y[:, None])
    solver = PeriodicPoissonSolver(nx, ny, dx, dy, dtype=jnp.float64)
    u = np.asarray(solver.solve(jnp.asarray(rhs)))
    expect = -rhs / (kx**2 + ky**2)
    np.testing.assert_allclose(u, expect, rtol=2e-2, atol=1e-10)


def _mg_operator_dense(u, acf, dx, dy, cell_centered):
    """Reference dense operator for MG tests: Laplacian(u) - acf*u."""
    ny, nx = u.shape
    facx, facy = 1 / dx**2, 1 / dy**2
    if not cell_centered:
        lap = _fd_laplacian_dirichlet(u, dx, dy)
    else:
        up = np.pad(u, 1)
        lap = np.zeros_like(u)
        # interior contributions
        lap += facx * (up[1:-1, :-2] + up[1:-1, 2:]) + facy * (up[:-2, 1:-1] + up[2:, 1:-1])
        lap -= 2 * (facx + facy) * u
        # boundary: one-sided 4/3 stencils (face Dirichlet)
        lap[:, 0] += facx * (u[:, 1] / 3 - 2 * u[:, 0])
        lap[:, -1] += facx * (u[:, -2] / 3 - 2 * u[:, -1])
        lap[0, :] += facy * (u[1, :] / 3 - 2 * u[0, :])
        lap[-1, :] += facy * (u[-2, :] / 3 - 2 * u[-1, :])
    return lap - acf * u


@pytest.mark.parametrize("n,cc", [(32, True), (31, False), (64, True), (63, False)])
def test_multigrid_solves(n, cc):
    dx, dy = 0.11, 0.13
    rng = np.random.default_rng(4)
    rhs = rng.standard_normal((n, n))
    acf = np.abs(rng.standard_normal((n, n))) * 2.0
    mg = MultiGrid(n, n, dx, dy, dtype=jnp.float64)
    assert mg.cell_centered == cc
    u = np.asarray(mg.solve(jnp.zeros((n, n)), jnp.asarray(rhs), jnp.asarray(acf),
                            tol_rel=1e-8, max_iters=60))
    res = _mg_operator_dense(u, acf, dx, dy, cc) - rhs
    assert np.max(np.abs(res)) < 1e-6 * max(1.0, np.max(np.abs(rhs)))


def test_multigrid_batched_components():
    # Bx,By share the acoef like hpmg solve1 (ref HpMultiGrid.H:20-36)
    n = 32
    rng = np.random.default_rng(5)
    rhs = rng.standard_normal((2, n, n))
    acf = np.abs(rng.standard_normal((n, n)))
    mg = MultiGrid(n, n, 0.2, 0.2, dtype=jnp.float64)
    u = np.asarray(mg.solve(jnp.zeros((2, n, n)), jnp.asarray(rhs),
                            jnp.asarray(acf), tol_rel=1e-8, max_iters=60))
    for b in range(2):
        res = _mg_operator_dense(u[b], acf, 0.2, 0.2, True) - rhs[b]
        assert np.max(np.abs(res)) < 1e-6


def test_multigrid_complex():
    # complex Helmholtz system as used by the laser envelope (hpmg solve2)
    n = 31
    rng = np.random.default_rng(6)
    rhs = rng.standard_normal((n, n)) + 1j * rng.standard_normal((n, n))
    acf = 1.5 + 0.7j
    mg = MultiGrid(n, n, 0.15, 0.15, dtype=jnp.float64)
    u = np.asarray(mg.solve(jnp.zeros((n, n), jnp.complex128),
                            jnp.asarray(rhs, jnp.complex128), acf,
                            tol_rel=1e-8, max_iters=60))
    res = _fd_laplacian_dirichlet(u.real, 0.15, 0.15) \
        + 1j * _fd_laplacian_dirichlet(u.imag, 0.15, 0.15) - acf * u - rhs
    assert np.max(np.abs(res)) < 1e-6
