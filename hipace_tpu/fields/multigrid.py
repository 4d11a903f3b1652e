"""2D geometric multigrid for -a(x,y)*u + Laplacian(u) = rhs, Dirichlet BC.

A JAX re-design of the reference's hand-rolled hpmg::MultiGrid
(ref: /root/reference/src/mg_solver/HpMultiGrid.{H,cpp}), used for the
explicit Bx/By solve (ref: Hipace.cpp:793-933) and the laser envelope
(complex variant, ref: MultiLaser.cpp:430-607).

Everything is expressed in dense array ops: red-black Gauss-Seidel with
checkerboard masks, Laplacian boundary terms as precomputed coefficient
arrays (no in-place edge updates), and grid transfer as SEPARABLE DENSE
MATMULS: the 2D restriction/prolongation stencils are outer products of
1D stencils, so `coarse = R_y @ r @ R_x^T` with banded (nc, nf) matrices,
and bilinear prolongation is `P = 2 R^T` per dim.

Two grid conventions, as in the reference (HpMultiGrid.cpp:1050-1065):

- even domain sizes ("cell-centered"): Dirichlet u=0 at the cell *faces*;
  boundary rows use the one-sided (4/3, -4) stencil
  (ref: HpMultiGrid.cpp:163-182). 2x2 cell-average restriction /
  piecewise-constant prolongation.

- odd domain sizes ("node-centered", recommended 2^N-1): Dirichlet u=0 at
  the ghost nodes, identical to the DST solver's convention. Full-weighting
  restriction / bilinear prolongation.

Supports real systems batched over a leading component axis with shared
a-coefficient (hpmg solve1: Bx,By) and complex systems (solve2: laser).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np


def _restrict_matrix_nd(nf: int) -> np.ndarray:
    """(nc, nf) full-weighting restriction: coarse node ic sits at fine
    node 2ic+1; row stencil [1, 2, 1]/4 (2D kernel = outer product /16)."""
    nc = (nf - 1) // 2
    R = np.zeros((nc, nf))
    for ic in range(nc):
        jf = 2 * ic + 1
        R[ic, jf - 1] = 0.25
        R[ic, jf] = 0.5
        R[ic, jf + 1] = 0.25
    return R


def _restrict_matrix_cc(nf: int) -> np.ndarray:
    """(nc, nf) 2-cell average restriction (2D kernel = outer product
    of [1, 1]/2 per dim = the 2x2 quarter average)."""
    nc = nf // 2
    R = np.zeros((nc, nf))
    for ic in range(nc):
        R[ic, 2 * ic] = 0.5
        R[ic, 2 * ic + 1] = 0.5
    return R


def _mm(A, x, B):
    """A @ x @ B^T over the trailing 2 dims of x at Precision.HIGHEST
    (the transfer flops are trivial, and a reduced-precision matmul would
    cap the solver's attainable residual). Complex x goes through as two
    real passes."""
    hi = jax.lax.Precision.HIGHEST

    def real_mm(xr):
        y = jnp.einsum("ij,...jk->...ik", A, xr, precision=hi)
        return jnp.einsum("...ik,lk->...il", y, B, precision=hi)

    if jnp.iscomplexobj(x):
        return real_mm(x.real) + 1j * real_mm(x.imag)
    return real_mm(x)


class MultiGrid:
    """Geometric multigrid solver; construct once per grid, reuse across jit."""

    def __init__(self, nx: int, ny: int, dx: float, dy: float,
                 dtype=jnp.float32):
        assert nx % 2 == ny % 2, "nx and ny must have the same parity"
        self.cell_centered = (nx % 2 == 0)
        self.dtype = dtype
        self.shapes = []
        self.facs = []
        n_x, n_y, ddx, ddy = nx, ny, dx, dy
        min_w = 2 if self.cell_centered else 3
        while True:
            self.shapes.append((n_y, n_x))
            self.facs.append((1.0 / (ddx * ddx), 1.0 / (ddy * ddy)))
            if self.cell_centered:
                if n_x % 2 or n_y % 2 or n_x // 2 < min_w or n_y // 2 < min_w:
                    break
                n_x //= 2
                n_y //= 2
            else:
                if (n_x - 1) % 2 or (n_y - 1) % 2 or (n_x - 1) // 2 < min_w \
                        or (n_y - 1) // 2 < min_w:
                    break
                n_x = (n_x - 1) // 2
                n_y = (n_y - 1) // 2
            ddx *= 2.0
            ddy *= 2.0
        self.nlevels = len(self.shapes)

        # checkerboard masks and boundary-coefficient arrays per level
        self.masks = []
        self.coefs = []   # (cW, cE, cS, cN) neighbor multipliers
        self.diags = []
        rdt = jnp.float32 if dtype in (jnp.float32, jnp.complex64) else \
            jnp.float64
        for lev, (n_y, n_x) in enumerate(self.shapes):
            iy, ix = np.mgrid[0:n_y, 0:n_x]
            self.masks.append(jnp.asarray((ix + iy) % 2 == 0))
            facx, facy = self.facs[lev]
            if self.cell_centered:
                # neighbor coefficient 4/3 on the boundary-facing side
                # (ref HpMultiGrid.cpp laplacian())
                cW = np.ones((n_y, n_x), np.float64)
                cE = np.ones((n_y, n_x), np.float64)
                cS = np.ones((n_y, n_x), np.float64)
                cN = np.ones((n_y, n_x), np.float64)
                cE[:, 0] = 4.0 / 3.0   # at i=0 the E neighbor gets 4/3
                cW[:, -1] = 4.0 / 3.0
                cN[0, :] = 4.0 / 3.0
                cS[-1, :] = 4.0 / 3.0
                dgx = np.full((n_x,), -2.0 * facx)
                dgx[0] = dgx[-1] = -4.0 * facx
                dgy = np.full((n_y,), -2.0 * facy)
                dgy[0] = dgy[-1] = -4.0 * facy
                diag = dgx[None, :] + dgy[:, None]
                self.coefs.append(tuple(jnp.asarray(c, rdt)
                                        for c in (cW, cE, cS, cN)))
                self.diags.append(jnp.asarray(diag, rdt))
            else:
                self.coefs.append(None)
                self.diags.append(jnp.asarray(-2.0 * (facx + facy), rdt))

        # separable grid-transfer matrices per fine level: coarse(r) =
        # Ry @ r @ Rx^T; prolong(c) = (2Ry)^T @ c @ (2Rx), and the
        # node-centered acf-coarsening denominator Ry @ 1 @ Rx^T
        self.Ry = []
        self.Rx = []
        self.acf_den = []
        rmat = _restrict_matrix_cc if self.cell_centered else \
            _restrict_matrix_nd
        for lev in range(self.nlevels - 1):
            n_y, n_x = self.shapes[lev]
            ry = rmat(n_y)
            rx = rmat(n_x)
            self.Ry.append(jnp.asarray(ry, rdt))
            self.Rx.append(jnp.asarray(rx, rdt))
            if not self.cell_centered:
                den = ry @ np.ones((n_y, n_x)) @ rx.T
                self.acf_den.append(jnp.asarray(den, rdt))

    # ------------------------------------------------------------------
    def _offdiag(self, u, lev):
        facx, facy = self.facs[lev]
        z = jnp.zeros_like(u[..., :, :1])
        uW = jnp.concatenate([z, u[..., :, :-1]], axis=-1)
        uE = jnp.concatenate([u[..., :, 1:], z], axis=-1)
        zr = jnp.zeros_like(u[..., :1, :])
        uS = jnp.concatenate([zr, u[..., :-1, :]], axis=-2)
        uN = jnp.concatenate([u[..., 1:, :], zr], axis=-2)
        if self.cell_centered:
            cW, cE, cS, cN = self.coefs[lev]
            return facx * (uW * cW + uE * cE) + facy * (uS * cS + uN * cN)
        return facx * (uW + uE) + facy * (uN + uS)

    def apply_op(self, u, acf, lev=0):
        """A(u) = Laplacian(u) - acf*u."""
        return self._offdiag(u, lev) + (self.diags[lev] - acf) * u

    def _smooth(self, u, rhs, acf, lev, sweeps):
        """Red-black Gauss-Seidel (each sweep = red + black)."""
        mask = self.masks[lev]
        inv_diag = 1.0 / (self.diags[lev] - acf)

        def one_color(u, m):
            upd = (rhs - self._offdiag(u, lev)) * inv_diag
            return jnp.where(m, upd, u)

        for _ in range(sweeps):
            u = one_color(u, mask)
            u = one_color(u, ~mask)
        return u

    # ------------------------------------------------------------------
    def _restrict(self, r, lev):
        """Restrict from level `lev` to lev+1: Ry @ r @ Rx^T."""
        return _mm(self.Ry[lev], r, self.Rx[lev])

    def _prolong_add(self, u, c, lev):
        """Prolong coarse c (level lev+1) onto fine u (level lev);
        P = 2 R^T per dim for both conventions (bilinear tent for
        node-centered, piecewise-constant injection for cell-centered)."""
        up = _mm(2.0 * self.Ry[lev].T, c, 2.0 * self.Rx[lev].T)
        return u + up

    def _coarsen_acf(self, acf):
        """Averaged-down a-coefficients per level (ref average_down_acoef)."""
        acfs = [acf]
        for lev in range(1, self.nlevels):
            a = acfs[-1]
            if jnp.ndim(a) == 0:
                acfs.append(a)
            elif self.cell_centered:
                acfs.append(_mm(self.Ry[lev - 1], a, self.Rx[lev - 1]))
            else:
                num = _mm(self.Ry[lev - 1], a, self.Rx[lev - 1])
                acfs.append(num / self.acf_den[lev - 1])
        return acfs

    def _vcycle(self, u, rhs, acfs, lev=0, nu1=2, nu2=2):
        u = self._smooth(u, rhs, acfs[lev], lev, nu1)
        if lev + 1 < self.nlevels:
            res = rhs - self.apply_op(u, acfs[lev], lev)
            crhs = self._restrict(res, lev)
            cu = jnp.zeros_like(crhs)
            cu = self._vcycle(cu, crhs, acfs, lev + 1, nu1, nu2)
            u = self._prolong_add(u, cu, lev)
            u = self._smooth(u, rhs, acfs[lev], lev, nu2)
        else:
            u = self._smooth(u, rhs, acfs[lev], lev, 8)
        return u

    # ------------------------------------------------------------------
    def solve(self, u0, rhs, acf, tol_rel=1e-4, tol_abs=0.0, max_iters=40,
              nu1=2, nu2=2):
        """Solve Laplacian(u) - acf*u = rhs starting from u0.

        u0/rhs may have a leading batch axis ((2, ny, nx) for Bx,By with
        shared acf, as in hpmg solve1). acf is (ny, nx), scalar, or complex.
        lax.while_loop with max-norm convergence matching hpmg
        (ref: HpMultiGrid.cpp:1308-1380)."""
        return self.solve_info(u0, rhs, acf, tol_rel, tol_abs, max_iters,
                               nu1, nu2)[0]

    def solve_info(self, u0, rhs, acf, tol_rel=1e-4, tol_abs=0.0,
                   max_iters=40, nu1=2, nu2=2):
        """solve() that also returns the number of V-cycles taken."""
        acfs = self._coarsen_acf(acf)

        res0 = rhs - self.apply_op(u0, acfs[0], 0)
        resnorm0 = jnp.max(jnp.abs(res0))
        rhsnorm0 = jnp.max(jnp.abs(rhs))
        target = jnp.maximum(tol_abs, jnp.maximum(tol_rel, 1e-16)
                             * jnp.maximum(resnorm0, rhsnorm0))

        def cond(carry):
            u, resnorm, it = carry
            return (resnorm > target) & (it < max_iters)

        def body(carry):
            u, _, it = carry
            u = self._vcycle(u, rhs, acfs, 0, nu1, nu2)
            res = rhs - self.apply_op(u, acfs[0], 0)
            return (u, jnp.max(jnp.abs(res)), it + 1)

        u, resnorm, it = jax.lax.while_loop(
            cond, body, (u0, resnorm0, jnp.zeros((), jnp.int32)))
        return u, it
