"""Transverse 2D Poisson solvers on slices, batched over components.

JAX equivalents of the reference's FFT Poisson solver family
(ref: /root/reference/src/fields/fft_poisson_solver/):

- `DirichletPoissonSolver`: solves Laplacian(u) = rhs with homogeneous
  Dirichlet boundary conditions at the ghost nodes (one cell outside the
  domain), exactly the discretization diagonalized by a DST-I. Matches the
  eigenvalue matrix of FFTPoissonSolverDirichletFast
  (ref: FFTPoissonSolverDirichletFast.cpp:224-248):
      lambda(kx, ky) = -4 [ sin^2((kx+1) pi / (2(nx+1))) / dx^2
                          + sin^2((ky+1) pi / (2(ny+1))) / dy^2 ]
  All 3-5 per-slice solves are batched into one call (leading batch axis).

- `PeriodicPoissonSolver`: C2C FFT with spectral -(kx^2+ky^2) division
  (ref: FFTPoissonSolverPeriodic.cpp).

Solvers are lightweight dataclasses holding precomputed eigenvalue arrays;
their solve methods are pure and jit-friendly.
"""

from __future__ import annotations

import math

import jax
import jax.numpy as jnp
import numpy as np

from ..ops.dst import dst1_2d, dst1_2d_fast


class DirichletPoissonSolver:
    """Batched DST-I Poisson solver for Laplacian(u) = rhs, u=0 at ghost nodes.

    variant: "expanded" (odd extension + rfft of length 2(N+1), any N) or
    "fast" (same-size rfft with sine twiddles, needs odd N; the reference's
    FFTDirichletFast and its GPU default)."""

    def __init__(self, nx: int, ny: int, dx: float, dy: float,
                 dtype=jnp.float32, variant: str = "expanded"):
        self.nx, self.ny = nx, ny
        self.dx, self.dy = dx, dy
        if variant == "fast" and (nx % 2 == 0 or ny % 2 == 0):
            variant = "expanded"   # fast DST needs odd sizes
        self._dst2d = dst1_2d_fast if variant == "fast" else dst1_2d
        kx = np.arange(nx)
        ky = np.arange(ny)
        sinx2 = np.sin((kx + 1) * math.pi / (2 * (nx + 1))) ** 2
        siny2 = np.sin((ky + 1) * math.pi / (2 * (ny + 1))) ** 2
        lam = -4.0 * (sinx2[None, :] / (dx * dx) + siny2[:, None] / (dy * dy))
        # include inverse-DST normalization 4/((nx+1)(ny+1)) in the eigenvalue
        norm = 4.0 / ((nx + 1) * (ny + 1))
        self.inv_eig = jnp.asarray(norm / lam, dtype=dtype)  # (ny, nx)

    def solve(self, rhs: jnp.ndarray) -> jnp.ndarray:
        """Solve Laplacian(u) = rhs. rhs shape (..., ny, nx) -> u same shape."""
        spec = self._dst2d(rhs)
        return self._dst2d(spec * self.inv_eig)

    def solve_helmholtz(self, rhs: jnp.ndarray, a: float) -> jnp.ndarray:
        """Solve (Laplacian - a) u = rhs for constant a (used as MG alternative
        and by the laser FFT solver with complex a)."""
        nx, ny = self.nx, self.ny
        kx = jnp.arange(nx)
        ky = jnp.arange(ny)
        sinx2 = jnp.sin((kx + 1) * math.pi / (2 * (nx + 1))) ** 2
        siny2 = jnp.sin((ky + 1) * math.pi / (2 * (ny + 1))) ** 2
        lam = -4.0 * (sinx2[None, :] / (self.dx ** 2)
                      + siny2[:, None] / (self.dy ** 2))
        norm = 4.0 / ((nx + 1) * (ny + 1))
        spec = dst1_2d(rhs)
        return dst1_2d(spec * (norm / (lam - a)))


class MGDirichletPoissonSolver:
    """Poisson via the geometric multigrid (ref MGPoissonSolverDirichlet.{H,cpp}:
    hpmg solve3 with zero a-coefficient). Same ghost-node Dirichlet
    convention as the DST solvers for odd sizes; supports 2^N sizes too."""

    def __init__(self, nx: int, ny: int, dx: float, dy: float,
                 dtype=jnp.float32, tol_rel: float = 1e-11):
        from .multigrid import MultiGrid
        self.mg = MultiGrid(nx, ny, dx, dy, dtype)
        self.tol_rel = tol_rel

    def solve(self, rhs: jnp.ndarray) -> jnp.ndarray:
        return self.mg.solve(jnp.zeros_like(rhs), rhs, 0.0,
                             tol_rel=self.tol_rel)


class PeriodicPoissonSolver:
    """Batched periodic Poisson solver via C2C FFT with spectral eigenvalues."""

    def __init__(self, nx: int, ny: int, dx: float, dy: float, dtype=jnp.float32):
        self.nx, self.ny = nx, ny
        kx = 2.0 * math.pi * np.fft.fftfreq(nx, d=dx)
        ky = 2.0 * math.pi * np.fft.fftfreq(ny, d=dy)
        k2 = kx[None, :] ** 2 + ky[:, None] ** 2
        inv = np.where(k2 == 0.0, 0.0, -1.0 / np.where(k2 == 0.0, 1.0, k2))
        self.inv_eig = jnp.asarray(inv, dtype=dtype)
        self.dtype = dtype

    def solve(self, rhs: jnp.ndarray) -> jnp.ndarray:
        spec = jnp.fft.fft2(rhs, axes=(-2, -1))
        out = jnp.fft.ifft2(spec * self.inv_eig, axes=(-2, -1))
        return out.real.astype(rhs.dtype)
