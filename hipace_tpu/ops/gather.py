"""Vectorized field gather onto particle arrays.

JAX equivalent of doGatherShapeN
(ref: /root/reference/src/particles/particles_utils/FieldGather.H:45-97):
for each particle, interpolates Ez, Bx, By, Bz with the order-p shape and
computes ExmBy = -dPsi/dx, EypBx = -dPsi/dy via the fused *nodal* derivative
shape factors (derivative_type 1 in the reference gather).

Fields are padded slice arrays (NY, NX) = (ny+2G, nx+2G); cell (ix, iy) lives
at array [iy+G, ix+G]. One XLA gather of shape (N, m, m) per field set.
"""

from __future__ import annotations

import jax.numpy as jnp

from .shape import shape_weights, shape_weights_derivative


def _stencil_indices(i0, m, G, n):
    """(N, m) int32 array of padded-array indices, clipped to bounds."""
    idx = i0[:, None] + jnp.arange(m, dtype=jnp.int32)[None, :] + G
    return jnp.clip(idx, 0, n - 1)


def gather_fields(xp, yp, fields, comps, geom, order):
    """Gather a list of field components at particle positions.

    fields: dict name -> (NY, NX) padded arrays.
    comps: sequence of names.
    Returns list of (N,) arrays.
    """
    G = geom.nguards
    NY, NX = geom.slice_shape
    x = (xp - geom.x_pos_offset) / geom.dx
    y = (yp - geom.y_pos_offset) / geom.dy
    ix0, wx = shape_weights(x, order)
    iy0, wy = shape_weights(y, order)
    m = order + 1
    jj = _stencil_indices(iy0, m, G, NY)
    ii0 = jnp.clip(ix0 + G, 0, NX - m)
    w = wy[:, :, None] * wx[:, None, :]                      # (N, m, m)
    stacked = jnp.stack([fields[c] for c in comps], axis=-1)
    vals = _row_sliced_fetch(stacked, jj, ii0, m)            # (N, m, m, C)
    out = jnp.sum(w[..., None] * vals, axis=(1, 2))          # (N, C)
    return [out[:, i] for i in range(len(comps))]


def _row_sliced_fetch(stacked, jj, ix0, mcols):
    """Fetch (N, nrows, mcols, C) stencil values with ONE gather of
    (1, mcols, C) row-slices: nrows gather rows per particle instead of
    nrows*mcols scalar elements. Out-of-range starts are slice-clipped;
    particles with in-bounds stencils (every valid particle — guard cells
    cover the stencil) read exactly the same elements as elementwise
    indexing."""
    import jax
    N, nrows = jj.shape
    C = stacked.shape[-1]
    starts = jnp.stack(
        [jj, jnp.broadcast_to(ix0[:, None], jj.shape)], axis=-1)
    out = jax.lax.gather(
        stacked, starts.reshape(N * nrows, 2),
        jax.lax.GatherDimensionNumbers(
            offset_dims=(1, 2, 3), collapsed_slice_dims=(),
            start_index_map=(0, 1)),
        slice_sizes=(1, mcols, C), mode="clip")
    return out.reshape(N, nrows, mcols, C)


def gather_main_fields(xp, yp, psi, ez, bx, by, bz, geom, order):
    """The main pusher gather: (ExmBy, EypBx, Ez, Bx, By, Bz).

    ExmBy/EypBx come from the nodal-derivative gather of Psi
    (ref FieldGather.H:76-95, derivative_type=1). All five source fields are
    fetched in ONE gather of per-row slices (stacked trailing component
    axis) so XLA issues m gather rows per particle, not 5*m*m.
    """
    G = geom.nguards
    NY, NX = geom.slice_shape
    dx_inv = 1.0 / geom.dx
    dy_inv = 1.0 / geom.dy
    x = (xp - geom.x_pos_offset) * dx_inv
    y = (yp - geom.y_pos_offset) * dy_inv

    m = order + 2
    ix0, wx, dwx = shape_weights_derivative(x, order, 1)
    iy0, wy, dwy = shape_weights_derivative(y, order, 1)
    ii0 = jnp.clip(ix0 + G, 0, NX - m)
    jj = _stencil_indices(iy0, m, G, NY)

    w = wy[:, :, None] * wx[:, None, :]
    w_dx = wy[:, :, None] * dwx[:, None, :]
    w_dy = dwy[:, :, None] * wx[:, None, :]

    stacked = jnp.stack([psi, ez, bx, by, bz], axis=-1)  # (NY, NX, 5)
    vals = _row_sliced_fetch(stacked, jj, ii0, m)        # (N, m, m, 5)
    psi_v = vals[..., 0]
    exmby = jnp.sum(w_dx * psi_v, axis=(1, 2)) * dx_inv
    eypbx = jnp.sum(w_dy * psi_v, axis=(1, 2)) * dy_inv
    rest = jnp.sum(w[..., None] * vals[..., 1:], axis=(1, 2))  # (N, 4)
    return exmby, eypbx, rest[:, 0], rest[:, 1], rest[:, 2], rest[:, 3]


def gather_laser_aabs(xp, yp, aabs, geom, order):
    """Gather |a|^2 and its on-the-fly centered derivatives
    (ref FieldGather.H:236-280 doLaserGatherShapeN)."""
    G = geom.nguards
    NY, NX = geom.slice_shape
    dx_inv = 1.0 / geom.dx
    dy_inv = 1.0 / geom.dy
    x = (xp - geom.x_pos_offset) * dx_inv
    y = (yp - geom.y_pos_offset) * dy_inv
    ix0, wx = shape_weights(x, order)
    iy0, wy = shape_weights(y, order)
    m = order + 1
    w = wy[:, :, None] * wx[:, None, :]
    # one (m+2)x(m+2) block fetch; the five shifted stencils are static
    # views into it (m+2 gather rows/particle instead of 5*m*m elements)
    mb = m + 2
    jj_ext = _stencil_indices(iy0 - 1, mb, G, NY)
    ii0 = jnp.clip(ix0 - 1 + G, 0, NX - mb)
    block = _row_sliced_fetch(aabs[:, :, None], jj_ext, ii0, mb)[..., 0]
    a00 = block[:, 1:m + 1, 1:m + 1]
    ap1 = block[:, 1:m + 1, 2:m + 2]
    am1 = block[:, 1:m + 1, 0:m]
    bp1 = block[:, 2:m + 2, 1:m + 1]
    bm1 = block[:, 0:m, 1:m + 1]
    a_v = jnp.sum(w * a00, axis=(1, 2))
    adx = jnp.sum(w * 0.5 * dx_inv * (ap1 - am1), axis=(1, 2))
    ady = jnp.sum(w * 0.5 * dy_inv * (bp1 - bm1), axis=(1, 2))
    return a_v, adx, ady
