"""Vectorized B-spline particle shape factors, orders 0-3.

JAX equivalent of the reference's scalar shape-factor templates
(ref: /root/reference/src/particles/particles_utils/ShapeFactors.H). The
reference's order-p polynomials are the cardinal B-splines B_p evaluated at
(x - cell); here we evaluate them branch-free on whole particle arrays and
return (leftmost cell index, weight matrix).

Also provides the fused derivative shape factors used by the field gather
(nodal type 1, ref FieldGather.H:70-95) and the explicit Sx/Sy deposition
(types 0/1/2, ref ShapeFactors.H:203-466):
  - type 0 (analytic):  stencil p+1, dxf_i = -B_p'(x - c_i)
  - type 1 (nodal):     stencil p+2, dxf_i = -B_{p+1}'(x - c_i)
  - type 2 (centered):  stencil p+3, dxf_i = (w_{i+1} - w_{i-1}) / 2
where w_i = B_p(x - c_i) and the reference's `dx_factor` == dxf here.
"""

from __future__ import annotations

import jax.numpy as jnp


def _bspline(u, p):
    """Cardinal B-spline B_p(u), branch-free."""
    au = jnp.abs(u)
    if p == 0:
        # half-open [-0.5, 0.5) to match floor(x+0.5) binning
        return jnp.where((u >= -0.5) & (u < 0.5), 1.0, 0.0)
    if p == 1:
        return jnp.maximum(0.0, 1.0 - au)
    if p == 2:
        inner = 0.75 - au * au
        outer = 0.5 * (1.5 - au) ** 2
        return jnp.where(au <= 0.5, inner, jnp.where(au < 1.5, outer, 0.0))
    if p == 3:
        inner = (4.0 - 6.0 * au * au + 3.0 * au ** 3) / 6.0
        outer = ((2.0 - au) ** 3) / 6.0
        return jnp.where(au <= 1.0, inner, jnp.where(au < 2.0, outer, 0.0))
    if p == 4:
        # only used through the derivative recurrence for order-3 nodal factors
        inner = 115.0 / 192.0 - (5.0 / 8.0) * au ** 2 + 0.25 * au ** 4
        mid = (55.0 + 20.0 * au - 120.0 * au ** 2 + 80.0 * au ** 3
               - 16.0 * au ** 4) / 96.0
        outer = ((2.5 - au) ** 4) / 24.0
        return jnp.where(au <= 0.5, inner,
                         jnp.where(au <= 1.5, mid,
                                   jnp.where(au < 2.5, outer, 0.0)))
    raise ValueError(f"unsupported shape order {p}")


def _bspline_deriv(u, p):
    """dB_p/du via the exact recurrence B_p'(u) = B_{p-1}(u+1/2) - B_{p-1}(u-1/2)."""
    assert p >= 1
    return _bspline(u + 0.5, p - 1) - _bspline(u - 0.5, p - 1)


def _leftmost(xmid, p):
    """Leftmost cell index of the order-p stencil (matches ShapeFactors.H)."""
    if p in (0, 2):
        return jnp.floor(xmid + 0.5).astype(jnp.int32) - p // 2
    return jnp.floor(xmid).astype(jnp.int32) - (p - 1) // 2


def shape_weights(xmid: jnp.ndarray, p: int, transposed: bool = False):
    """Shape factors: returns (i0 (N,), w (N, p+1)) with w_k = B_p(x - (i0+k)).

    transposed=True returns w as (p+1, N) — generated elementwise in that
    layout, so consumers that want tap-major weights avoid an XLA relayout
    copy of the (N, p+1) array.
    """
    i0 = _leftmost(xmid, p)
    offs = jnp.arange(p + 1, dtype=jnp.int32)
    if transposed:
        u = xmid[None, :] - (i0[None, :] + offs[:, None]).astype(xmid.dtype)
        return i0, _bspline(u, p)
    u = xmid[..., None] - (i0[..., None] + offs).astype(xmid.dtype)
    return i0, _bspline(u, p)


def shape_weights_derivative(xmid: jnp.ndarray, p: int, deriv_type: int,
                             transposed: bool = False):
    """Fused shape + derivative factors.

    Returns (i0 (N,), w (N, m), dxf (N, m)) with m = p + deriv_type + 1,
    matching single_derivative_shape_factor (ref ShapeFactors.H:211-466):
    w is the order-p shape embedded in the derivative stencil and
    dxf the reference's `dx_factor` (= -sdx). transposed=True returns
    (m, N) layouts (see shape_weights).
    """
    if deriv_type == 0:
        m = p + 1
        i0 = _leftmost(xmid, p)
    elif deriv_type == 1:
        m = p + 2
        i0 = _leftmost(xmid, p + 1)
    elif deriv_type == 2:
        m = p + 3
        i0 = _leftmost(xmid, p) - 1
    else:
        raise ValueError(f"unsupported derivative type {deriv_type}")

    offs = jnp.arange(m, dtype=jnp.int32)
    if transposed:
        u = xmid[None, :] - (i0[None, :] + offs[:, None]).astype(xmid.dtype)
        tap_axis = 0
    else:
        u = xmid[..., None] - (i0[..., None] + offs).astype(xmid.dtype)
        tap_axis = -1
    w = _bspline(u, p)
    if deriv_type == 0:
        dxf = -_bspline_deriv(u, p)
    elif deriv_type == 1:
        dxf = -_bspline_deriv(u, p + 1)
    else:
        zero = jnp.take(jnp.zeros_like(w), jnp.arange(1), axis=tap_axis)
        w_r = jnp.concatenate(
            [jnp.take(w, jnp.arange(1, m), axis=tap_axis), zero],
            axis=tap_axis)
        w_l = jnp.concatenate(
            [zero, jnp.take(w, jnp.arange(m - 1), axis=tap_axis)],
            axis=tap_axis)
        dxf = 0.5 * (w_r - w_l)
    return i0, w, dxf
