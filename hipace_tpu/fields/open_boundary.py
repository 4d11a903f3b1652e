"""Open (free-space) transverse field boundaries via multipole expansion.

A JAX re-design of the reference's 18th-order Taylor expansion of the
2D Green's function (ref: /root/reference/src/fields/OpenBoundary.H:34-52,
Fields.cpp:685-760 SetOpenBoundaryCondition): the potential on the domain
edge is

    phi(z) = dx dy/(4 pi) * [ M_0 ln|zs|^2 - 2 sum_{o=1..18} Re(M_o w^o)/o ]

with zs = z*scale, w = 1/zs and complex source moments
M_o = sum_cells s * (z'*scale)^o.  The reference's 37 real coefficients are
exactly Re/Im of these 18 complex moments (plus the real monopole); the
harmonic-polynomial tables in OpenBoundary.H collapse to two lax.scan power
recurrences here.  Sources outside 95% of the inscribed radius are ignored
(the Taylor series only converges for |z'| < |z|, so corner sources must be
dropped, ref Fields.cpp:710-714).

The Dirichlet solve then absorbs phi as an inhomogeneous ghost-node value:
rhs_edge -= phi_ghost / dx^2 (Van Loan; ref Fields.cpp:628-675
SetDirichletBoundaries with BoundaryOffset=1, BoundaryFactor=1 for the DST
solvers).
"""

from __future__ import annotations

import math

import jax
import jax.numpy as jnp
import numpy as np

from ..geometry import Geometry

N_ORDERS = 18


class OpenBoundary:
    """Precomputes the static source/edge coordinate arrays for one grid."""

    def __init__(self, geom: Geometry, dtype):
        g = geom
        self.geom = geom
        lx = g.prob_hi[0] - g.prob_lo[0]
        ly = g.prob_hi[1] - g.prob_lo[1]
        self.scale = 3.0 / math.sqrt(lx * lx + ly * ly)
        radius = min(abs(g.prob_lo[0]), abs(g.prob_hi[0]),
                     abs(g.prob_lo[1]), abs(g.prob_hi[1]))
        if radius <= 0.0:
            raise ValueError(
                "open boundaries need x=0, y=0 inside the domain (expansion "
                "point, ref Fields.cpp:706-708)")
        cutoff_sq = (0.95 * radius * self.scale) ** 2

        xs = (np.arange(g.nx) + 0.5) * g.dx + g.prob_lo[0]
        ys = (np.arange(g.ny) + 0.5) * g.dy + g.prob_lo[1]
        X, Y = np.meshgrid(xs * self.scale, ys * self.scale)
        self.ctype = jnp.complex64 if dtype == jnp.float32 else jnp.complex128
        zs = X + 1j * Y
        self.zsrc = jnp.asarray(
            np.where(X * X + Y * Y > cutoff_sq, 0.0, zs), self.ctype)
        self.mask = jnp.asarray(X * X + Y * Y <= cutoff_sq, bool)
        self.dxdy_div_4pi = g.dx * g.dy / (4.0 * math.pi)

        # ghost-node coordinates (offset = 1 cell beyond the edge cells)
        xb = xs
        yb = ys
        x_lo = xs[0] - g.dx
        x_hi = xs[-1] + g.dx
        y_lo = ys[0] - g.dy
        y_hi = ys[-1] + g.dy
        # bottom/top rows (y ghost), left/right columns (x ghost)
        zb = np.concatenate([
            xb + 1j * y_lo,            # bottom edge (rhs[0, :])
            xb + 1j * y_hi,            # top edge (rhs[-1, :])
            x_lo + 1j * yb,            # left edge (rhs[:, 0])
            x_hi + 1j * yb,            # right edge (rhs[:, -1])
        ]) * self.scale
        self.zedge = jnp.asarray(zb, self.ctype)
        self.inv_dy2 = 1.0 / (g.dy * g.dy)
        self.inv_dx2 = 1.0 / (g.dx * g.dx)

    def moments(self, src):
        """Complex moments M_o, o = 0..18, of an interior (ny, nx) source."""
        s = jnp.where(self.mask, src, 0.0).astype(self.ctype)

        def body(zp, _):
            m = jnp.sum(s * zp)
            return zp * self.zsrc, m

        _, ms = jax.lax.scan(body, jnp.ones_like(self.zsrc),
                             None, length=N_ORDERS + 1)
        return ms                                   # (19,) complex

    def edge_potential(self, ms, monopole: bool = True):
        """phi at the ghost nodes, (2nx + 2ny,) real."""
        w = 1.0 / self.zedge
        m0 = jnp.real(ms[0]) if monopole else jnp.zeros((), ms.real.dtype)
        phi = m0 * jnp.log(jnp.abs(self.zedge) ** 2)

        def body(wp, o):
            term = -2.0 * jnp.real(ms[o] * wp) / o.astype(phi.dtype)
            return wp * w, term

        _, terms = jax.lax.scan(body, w, jnp.arange(1, N_ORDERS + 1))
        return (phi + jnp.sum(terms, axis=0)) * self.dxdy_div_4pi

    def apply(self, rhs, monopole: bool = True):
        """Subtract the open-boundary ghost values from an interior rhs
        (ref SetDirichletBoundaries: rhs_edge -= phi_ghost / dcell^2)."""
        ny, nx = rhs.shape
        ms = self.moments(rhs)
        phi = self.edge_potential(ms, monopole)
        bot = phi[:nx]
        top = phi[nx:2 * nx]
        left = phi[2 * nx:2 * nx + ny]
        right = phi[2 * nx + ny:]
        rhs = rhs.at[0, :].add(-bot * self.inv_dy2)
        rhs = rhs.at[-1, :].add(-top * self.inv_dy2)
        rhs = rhs.at[:, 0].add(-left * self.inv_dx2)
        rhs = rhs.at[:, -1].add(-right * self.inv_dx2)
        return rhs
