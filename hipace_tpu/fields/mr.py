"""Transverse mesh refinement (MR): nested fine levels in (x, y).

A JAX re-design of the reference's MR machinery:
- per-level geometry:        /root/reference/src/Hipace.cpp:327-374
  (fine levels refine x/y only; z keeps the coarse dz, the patch z-range
  snaps to coarse slices and gives the per-slice current_N_level,
  Hipace.cpp:569-576)
- coarse->fine interpolation: Fields::LevelUp / LevelUpBoundary
  (Fields.cpp:762-838) built on interpolated_field_xy (Fields.cpp:281-330),
  order-2 B-spline shape factors
- fine-level Dirichlet BCs:   Fields::SetBoundaryCondition lev>0 branch
  (Fields.cpp:678-760): the coarse solution is interpolated at boundary
  nodes and absorbed into the RHS by the Van Loan correction
  (SetDirichletBoundaries, Fields.cpp:628-675)

The coarse->fine evaluation at the *static* fine cell positions is a
pair of small dense matrices applied per axis (separable order-2
interpolation): F = Wy @ C @ Wx^T — a matmul instead of a gather kernel.
Every product runs at Precision.HIGHEST (see _mm3).
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np

from ..geometry import Geometry
from ..parser import Inputs


def _mm3(a, b, c):
    """a @ b @ c in full f32 (or f64) precision: without an explicit
    precision an f32 matmul may run as TF32 (~3 decimal digits)."""
    hi = jax.lax.Precision.HIGHEST
    return jnp.matmul(jnp.matmul(a, b, precision=hi), c, precision=hi)


@dataclasses.dataclass(frozen=True)
class MRLevel:
    """Static config of one fine level (hashable, closed over by jit)."""
    geom: Geometry
    zeta_lo: int   # coarse slice index range where the level is active
    zeta_hi: int


def parse_mr_levels(inputs: Inputs, geom0: Geometry) -> tuple:
    """Read mr_lev<N>.n_cell/patch_lo/patch_hi (ref Hipace.cpp:327-374)."""
    max_level = inputs.query("amr.max_level", 0, int)
    levels = []
    prev = geom0
    for lev in range(1, max_level + 1):
        pp = inputs.prefix(f"mr_lev{lev}")
        n_cell = pp.get_list("n_cell", int)          # (nx, ny)
        patch_lo = pp.get_list("patch_lo")
        patch_hi = pp.get_list("patch_hi")
        # z range snaps to coarse slices (ref Hipace.cpp:339-350)
        pos_off_z = geom0.z_pos_offset
        zeta_lo = max(0, round((patch_lo[2] - pos_off_z) / geom0.dz))
        zeta_hi = min(geom0.nz - 1, round((patch_hi[2] - pos_off_z) / geom0.dz))
        lo_z = (zeta_lo - 0.5) * geom0.dz + pos_off_z
        hi_z = (zeta_hi + 0.5) * geom0.dz + pos_off_z
        g = Geometry(
            n_cell=(int(n_cell[0]), int(n_cell[1]), zeta_hi - zeta_lo + 1),
            prob_lo=(patch_lo[0], patch_lo[1], lo_z),
            prob_hi=(patch_hi[0], patch_hi[1], hi_z),
            nguards=geom0.nguards, is_periodic=(False, False, False))
        # nesting check (ref Hipace.cpp:358-370)
        if not (g.prob_lo[0] - 2 * g.dx - 2 * prev.dx > prev.prob_lo[0]
                and g.prob_hi[0] + 2 * g.dx + 2 * prev.dx < prev.prob_hi[0]
                and g.prob_lo[1] - 2 * g.dy - 2 * prev.dy > prev.prob_lo[1]
                and g.prob_hi[1] + 2 * g.dy + 2 * prev.dy < prev.prob_hi[1]):
            raise ValueError(
                f"mr_lev{lev} must be fully nested inside the next coarsest "
                "level (with a few cells to spare, ref Hipace.cpp:358-370)")
        levels.append(MRLevel(geom=g, zeta_lo=zeta_lo, zeta_hi=zeta_hi))
        prev = g
    return tuple(levels)


def _np_bspline(u, p):
    """Cardinal B-spline B_p(u) in numpy (mirrors ops/shape.py)."""
    au = np.abs(u)
    if p == 0:
        return np.where((u >= -0.5) & (u < 0.5), 1.0, 0.0)
    if p == 1:
        return np.maximum(0.0, 1.0 - au)
    if p == 2:
        return np.where(au <= 0.5, 0.75 - au * au,
                        np.where(au < 1.5, 0.5 * (1.5 - au) ** 2, 0.0))
    if p == 3:
        return np.where(au <= 1.0, (4.0 - 6.0 * au * au + 3.0 * au ** 3) / 6.0,
                        np.where(au < 2.0, ((2.0 - au) ** 3) / 6.0, 0.0))
    raise ValueError(f"unsupported shape order {p}")


def _np_shape_weights(xmid: np.ndarray, p: int = 2):
    """Order-p B-spline shape factors in pure numpy (this runs at trace
    time, so it must not create jax ops; mirrors ops/shape.py)."""
    if p in (0, 2):
        i0 = np.floor(xmid + 0.5).astype(np.int64) - p // 2
    else:
        i0 = np.floor(xmid).astype(np.int64) - (p - 1) // 2
    u = xmid[:, None] - (i0[:, None] + np.arange(p + 1))
    return i0, _np_bspline(u, p)


def _np_shape_weights_o2(xmid: np.ndarray):
    return _np_shape_weights(xmid, 2)


def _interp_matrix_1d(fine_coords, coarse_geom: Geometry, axis: int,
                      n_coarse_padded: int) -> np.ndarray:
    """Dense (n_fine, n_coarse_padded) order-2 B-spline interpolation
    matrix evaluating a padded coarse axis at the given fine coordinates."""
    G = coarse_geom.nguards
    d = coarse_geom.cell_size(axis)
    off = coarse_geom.pos_offset(axis)
    xmid = (np.asarray(fine_coords, float) - off) / d
    i0, w = _np_shape_weights_o2(xmid)
    M = np.zeros((len(xmid), n_coarse_padded))
    rows = np.arange(len(xmid))
    for k in range(3):
        idx = i0 + k + G
        if (idx < 0).any() or (idx >= n_coarse_padded).any():
            raise ValueError("fine level not nested: interpolation stencil "
                             "leaves the padded coarse array")
        M[rows, idx] += w[:, k]
    return M


class LevelCoupler:
    """Precomputed coarse->fine interpolation operators for one fine level.

    All operators act on padded slice arrays (NY, NX) of the two levels.
    """

    def __init__(self, coarse: Geometry, fine: Geometry, dtype):
        self.coarse = coarse
        self.fine = fine
        self.dtype = dtype
        Gf = fine.nguards
        NYc, NXc = coarse.slice_shape
        NYf, NXf = fine.slice_shape

        # fine padded cell-center coordinates
        xf = (np.arange(NXf) - Gf + 0.5) * fine.dx + fine.prob_lo[0]
        yf = (np.arange(NYf) - Gf + 0.5) * fine.dy + fine.prob_lo[1]
        self.Wx = jnp.asarray(_interp_matrix_1d(xf, coarse, 0, NXc), dtype)
        self.Wy = jnp.asarray(_interp_matrix_1d(yf, coarse, 1, NYc), dtype)

        # boundary-node rows for the Van Loan BC corrections: edge cell
        # position shifted outward by `offset` fine cells
        # (ref SetDirichletBoundaries, Fields.cpp:663-668)
        self._bc_rows = {}
        for offset in (1.0, 0.5):
            xlo = fine.prob_lo[0] + (0.5 - offset) * fine.dx
            xhi = fine.prob_hi[0] - (0.5 - offset) * fine.dx
            ylo = fine.prob_lo[1] + (0.5 - offset) * fine.dy
            yhi = fine.prob_hi[1] - (0.5 - offset) * fine.dy
            self._bc_rows[offset] = tuple(
                jnp.asarray(_interp_matrix_1d([v], coarse, ax, n)[0], dtype)
                for v, ax, n in ((xlo, 0, NXc), (xhi, 0, NXc),
                                 (ylo, 1, NYc), (yhi, 1, NYc)))
        # interior interpolation rows (for boundary values along edges)
        self.Wx_int = self.Wx[Gf:NXf - Gf]
        self.Wy_int = self.Wy[Gf:NYf - Gf]

        self._band_masks = {}

    # ------------------------------------------------------------------
    def up_full(self, c):
        """LevelUp (ref Fields.cpp:808-838): full padded interpolation."""
        return _mm3(self.Wy, c, self.Wx.T)

    def _band(self, outer: int, inner: int):
        """Mask of fine padded cells in grown(valid, outer) \\ grown(valid,
        inner). IntVect semantics of LevelUpBoundary (Fields.cpp:762-806)."""
        key = (outer, inner)
        if key not in self._band_masks:
            G = self.fine.nguards
            NYf, NXf = self.fine.slice_shape
            ny, nx = self.fine.ny, self.fine.nx

            def box(e):
                m = np.zeros((NYf, NXf), bool)
                m[max(0, G - e):min(NYf, G + ny + e),
                  max(0, G - e):min(NXf, G + nx + e)] = True
                return m

            self._band_masks[key] = jnp.asarray(box(outer) & ~box(inner))
        return self._band_masks[key]

    def up_boundary(self, f, c, outer: int, inner: int):
        """LevelUpBoundary: replace the band cells of fine `f` with the
        interpolated coarse `c` (compensates incomplete deposition near the
        patch edge / fills ghosts from the coarse solution)."""
        if outer == inner:
            return f
        return jnp.where(self._band(outer, inner), self.up_full(c), f)

    # ------------------------------------------------------------------
    def bc_values(self, c, offset: float):
        """Coarse solution at the 4 fine boundary edges (bot, top, left,
        right), each along the fine interior axis."""
        rxlo, rxhi, rylo, ryhi = self._bc_rows[offset]
        bot = _mm3(rylo, c, self.Wx_int.T)     # (nxf,)
        top = _mm3(ryhi, c, self.Wx_int.T)
        left = _mm3(self.Wy_int, c, rxlo)      # (nyf,)
        right = _mm3(self.Wy_int, c, rxhi)
        return bot, top, left, right

    def apply_bc(self, rhs, c, offset: float, factor: float):
        """Van Loan RHS correction on a fine interior rhs (ny, nx) with
        boundary values interpolated from the padded coarse solution `c`
        (ref SetDirichletBoundaries: rhs_edge -= bc * factor / dcell^2)."""
        bot, top, left, right = self.bc_values(c, offset)
        inv_dy2 = factor / (self.fine.dy * self.fine.dy)
        inv_dx2 = factor / (self.fine.dx * self.fine.dx)
        rhs = rhs.at[0, :].add(-bot * inv_dy2)
        rhs = rhs.at[-1, :].add(-top * inv_dy2)
        rhs = rhs.at[:, 0].add(-left * inv_dx2)
        rhs = rhs.at[:, -1].add(-right * inv_dx2)
        return rhs


def _cross_matrix_1d(dst_coords, src_geom: Geometry, axis: int,
                     n_src_padded: int, order: int,
                     valid_only: bool) -> np.ndarray:
    """(n_dst, n_src_padded) order-`order` interpolation matrix; taps that
    fall outside the source array (or, with valid_only, outside the source
    VALID box) contribute zero — the clip semantics of the reference's
    cross-grid laser interpolation (ref MultiLaser.cpp:269-283)."""
    G = src_geom.nguards
    d = src_geom.cell_size(axis)
    off = src_geom.pos_offset(axis)
    xmid = (np.asarray(dst_coords, float) - off) / d
    i0, w = _np_shape_weights(xmid, order)
    M = np.zeros((len(xmid), n_src_padded))
    rows = np.arange(len(xmid))
    lo = G if valid_only else 0
    hi = (n_src_padded - G) if valid_only else n_src_padded
    for k in range(order + 1):
        idx = i0 + k + G
        ok = (idx >= lo) & (idx < hi)
        M[rows[ok], idx[ok]] += w[ok, k]
    return M


class GridInterp:
    """Separable cross-grid interpolation of padded slice arrays:
    dst = Wy @ src @ Wx^T, used for the laser <-> field grid coupling
    (ref MultiLaser::InterpolateChi / UpdateLaserAabs)."""

    def __init__(self, src: Geometry, dst: Geometry, dtype, order: int = 1,
                 valid_only: bool = False):
        G = dst.nguards
        NYs, NXs = src.slice_shape
        NYd, NXd = dst.slice_shape
        xd = (np.arange(NXd) - G + 0.5) * dst.dx + dst.prob_lo[0]
        yd = (np.arange(NYd) - G + 0.5) * dst.dy + dst.prob_lo[1]
        self.Wx = jnp.asarray(
            _cross_matrix_1d(xd, src, 0, NXs, order, valid_only), dtype)
        self.Wy = jnp.asarray(
            _cross_matrix_1d(yd, src, 1, NYs, order, valid_only), dtype)

    def apply(self, a):
        return _mm3(self.Wy, a, self.Wx.T)


def in_level_bounds(x, y, geom: Geometry):
    """CheckDomainBounds.contains (transverse)."""
    return ((x >= geom.prob_lo[0]) & (x < geom.prob_hi[0])
            & (y >= geom.prob_lo[1]) & (y < geom.prob_hi[1]))


def tag_by_level(x, y, valid, levels) -> jnp.ndarray:
    """TagByLevel (ref PlasmaParticleContainer.cpp:220-259): finest level
    whose transverse bounds contain the particle. levels: list of Geometry
    (fine levels, index 0 = lev1)."""
    tag = jnp.zeros(x.shape, jnp.int32)
    for i, g in enumerate(levels):
        tag = jnp.where(in_level_bounds(x, y, g), i + 1, tag)
    return jnp.where(valid, tag, 0)
