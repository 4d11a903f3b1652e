"""Scatter-add particle deposition onto slice arrays.

JAX equivalent of the reference's SharedMemoryDeposition engine
(ref: /root/reference/src/particles/deposition/DepositionUtil.H:40-120). The
GPU reference builds per-tile linked lists and accumulates in shared memory
with atomics; here the deposit is XLA's scatter-add (`.at[].add`) over
flattened (N * m * m) index/value arrays, which XLA lowers to atomic adds
on the GPU — the reference's own global-atomics design without the
shared-memory tiling.

All deposits for one species are fused into a single scatter by stacking the
deposited components along a leading axis.
"""

from __future__ import annotations

import jax.numpy as jnp

from .shape import shape_weights, shape_weights_derivative


def deposit_multi(fields_stack, xp, yp, values, geom, order):
    """Scatter-add `values` (list of (N,) arrays, one per component in the
    leading axis of fields_stack) with order-p shapes.

    fields_stack: (C, NY, NX) padded array. Returns updated stack.
    Invalid particles must carry zero values.
    """
    G = geom.nguards
    C, NY, NX = fields_stack.shape
    x = (xp - geom.x_pos_offset) / geom.dx
    y = (yp - geom.y_pos_offset) / geom.dy
    ix0, wx = shape_weights(x, order)
    iy0, wy = shape_weights(y, order)
    m = order + 1
    # stencil taps outside the padded array are DROPPED (zero weight), not
    # clamped: charge beyond the guard band never piles into the outermost
    # guard cell. Matches the banded kernels; only possible for
    # out-of-domain beam lanes (plasma is BC-enforced in-domain and the
    # guard band covers its stencil reach).
    ii_raw = ix0[:, None] + jnp.arange(m, dtype=jnp.int32) + G
    jj_raw = iy0[:, None] + jnp.arange(m, dtype=jnp.int32) + G
    wx = wx * ((ii_raw >= 0) & (ii_raw < NX))
    wy = wy * ((jj_raw >= 0) & (jj_raw < NY))
    ii = jnp.clip(ii_raw, 0, NX - 1)
    jj = jnp.clip(jj_raw, 0, NY - 1)
    w = wy[:, :, None] * wx[:, None, :]                       # (N, m, m)
    jf = jnp.broadcast_to(jj[:, :, None], (len(x), m, m)).reshape(-1)
    if_ = jnp.broadcast_to(ii[:, None, :], (len(x), m, m)).reshape(-1)
    lin = jf * NX + if_                                       # (N*m*m,)

    # ONE scatter with a C-wide payload row per stencil cell
    vstack = jnp.stack(values, axis=-1)                       # (N, C)
    payload = (w[..., None] * vstack[:, None, None, :]).reshape(-1, C)
    flat = fields_stack.reshape(C, NY * NX).T                 # (NY*NX, C)
    flat = flat.at[lin, :].add(payload)
    return flat.T.reshape(C, NY, NX)


def deposit_single(field, xp, yp, value, geom, order):
    """Scatter-add one component. field: (NY, NX)."""
    out = deposit_multi(field[None], xp, yp, [value], geom, order)
    return out[0]



