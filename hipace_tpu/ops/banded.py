"""Banded matmul particle kernels: deposition and gather as one-hot products.

The alternative to the per-particle scatter-add/gather of ops/deposit.py
and ops/gather.py: deposition and interpolation are expressed as dense
one-hot matrix products over *bands* of rows, a dense-matmul analogue of
the reference's shared-memory tile deposition (ref: src/
particles/deposition/DepositionUtil.H:40-120: sort by tile, accumulate in
on-chip memory). Every f32 contraction is pinned to Precision.HIGHEST so
that no backend lowers it to a reduced-precision (e.g. TF32) matmul.

Particles must be pre-sorted by their current row (the caller sorts once
per slice, which also plays the role of the reference's ReorderParticles).
The sorted stream is processed in chunks of K; each chunk deposits into /
gathers from a W-row window anchored at its first particle's row.
Contributions that fall outside the window (only possible when a chunk
spans more than W - my rows, i.e. fewer than K/W particles per row — e.g.
sparse edge rows thinned by absorbing boundaries) are handled exactly by a
corrective pass: a 0/1-trip lax.while_loop re-processes the wide lanes with
an elementwise scatter/gather, so nothing is ever dropped (matching ref
DepositionUtil/SliceSort, which never drop either) and the common case pays
only one predicate evaluation.

API contract: the kernels take guard-offset CELL POSITIONS (xm, ym —
(pos - offset)/dcell + nguards, with invalid lanes set to a sentinel
>= 2*NY) and compute the B-spline shape weights per chunk INSIDE the scan
body, exactly like the reference's device kernels, so the weights fuse
into the one-hot build instead of being materialized as (N, m) arrays.

  deposit:  window(W*C, WX) += [Wy^T x values] (W*C, K) @ Wx (K, WX)
  gather:   tmp = Wx (K, WX) @ window (WX, W*C)
            out[k, c] = sum_r Wy[k, r] * tmp[k, r, c]
"""

from __future__ import annotations

from functools import partial
from typing import NamedTuple

import jax
import jax.numpy as jnp

from .shape import shape_weights, shape_weights_derivative


class BandedOpts(NamedTuple):
    """Window/chunk sizes for the banded particle kernels, passed through
    the deposit/gather call sites (plasma.py / step.py): W-row windows,
    K-particle chunks, WX-column windows (0 = full rows)."""
    W: int = 32
    K: int = 8192
    WX: int = 0


_HI = jax.lax.Precision.HIGHEST


# ----------------------------------------------------------------------
# dispatchers (value lists are stacked channel-minor)
# ----------------------------------------------------------------------
def dispatch_deposit(fields, ym, xm, val_list, opts: BandedOpts, NY, NX,
                     order, deriv_type=-1, ykind="w", xkind="w"):
    """Deposit the per-particle value vectors into fields (C, NY, NX);
    returns (fields, lost)."""
    return banded_deposit(fields, ym, xm, jnp.stack(val_list, axis=-1),
                          NY, NX, order, W=min(opts.W, NY), K=opts.K,
                          WX=opts.WX, deriv_type=deriv_type, ykind=ykind,
                          xkind=xkind)


def dispatch_deposit_multi(fields, ym, xm, val_list, ykinds,
                           opts: BandedOpts, NY, NX, order, deriv_type):
    """Multi-block deposit sharing one x weight matrix."""
    return banded_deposit_multi(fields, ym, xm,
                                jnp.stack(val_list, axis=-1), ykinds,
                                NY, NX, order, deriv_type,
                                W=min(opts.W, NY), K=opts.K, WX=opts.WX)


def dispatch_deposit_blocks(fields, ym, xm, val_list, blocks,
                            opts: BandedOpts, NY, NX, order, deriv_type):
    """Deposit channel blocks with per-block (ykind, xkind) weights:
    one shared-x multi deposit (xkind "w" blocks) plus one deposit per
    remaining block."""
    lost = jnp.zeros((), jnp.int32)
    # group the xkind=="w" blocks into one shared-x multi deposit
    wk = [(i, yk, ci) for i, (yk, xk, ci) in enumerate(blocks)
          if xk == "w"]
    offs = []
    off = 0
    for yk, xk, ci in blocks:
        offs.append(off)
        off += ci
    out = fields
    if wk:
        idx = []
        for i, yk, ci in wk:
            idx.extend(range(offs[i], offs[i] + ci))
        sub = jnp.stack([val_list[j] for j in idx], axis=-1)
        subf = out[jnp.asarray(idx)] if len(idx) != len(val_list) \
            else out
        subf, lost1 = banded_deposit_multi(
            subf, ym, xm, sub, tuple((yk, ci) for _, yk, ci in wk),
            NY, NX, order, deriv_type, W=min(opts.W, NY), K=opts.K,
            WX=opts.WX)
        lost = lost + lost1
        if len(idx) != len(val_list):
            out = out.at[jnp.asarray(idx)].set(subf)
        else:
            out = subf
    for i, (yk, xk, ci) in enumerate(blocks):
        if xk == "w":
            continue
        sub = jnp.stack(val_list[offs[i]:offs[i] + ci], axis=-1)
        subf, lost1 = banded_deposit(
            out[offs[i]:offs[i] + ci], ym, xm, sub, NY, NX, order,
            W=min(opts.W, NY), K=opts.K, WX=opts.WX,
            deriv_type=deriv_type, ykind=yk, xkind=xk)
        lost = lost + lost1
        out = out.at[offs[i]:offs[i] + ci].set(subf)
    return out, lost


def dispatch_gather_main(field_list, ym, xm, opts: BandedOpts, NY, NX,
                         order):
    """Fused main-fields gather; field_list = [Psi, Ez, Bx, By, Bz]
    slice arrays. Returns (exmby_raw, eypbx_raw, ez, bx, by, bz, lost)."""
    return banded_gather_main(jnp.stack(field_list, axis=-1), ym, xm,
                              NY, NX, order, W=min(opts.W, NY), K=opts.K,
                              WX=opts.WX)


def _taps(c, order, deriv_type):
    """In-body shape factors: (i0, w (K, m), dw (K, m) | None)."""
    if deriv_type < 0:
        i0, w = shape_weights(c, order)
        return i0, w, None
    return shape_weights_derivative(c, order, deriv_type)


def _ntaps(order, deriv_type):
    return order + 1 if deriv_type < 0 else order + deriv_type + 1


def _onehot_w(rel, weights, width):
    """(K, width) matrix with weights (K, m) placed at columns
    rel..rel+m-1."""
    K, m = weights.shape
    cols = jax.lax.broadcasted_iota(jnp.int32, (K, width), 1)
    out = jnp.zeros((K, width), weights.dtype)
    for a in range(m):
        out = out + weights[:, a:a + 1] * (cols == (rel + a)[:, None])
    return out


def _anchors2d(ciy0, cix0, my, mx, NY, NX, W, WX):
    """Per-chunk 2D window anchor (ay, ax) and in-window mask.

    The y anchor is the chunk's min row; with the stripe-snake sort
    (step.py _row_sort: stripes of H rows, x-ascending boustrophedon) a
    chunk spans at most 2 stripes -> rely + my <= 2H + my <= W. The x
    anchor is the min column over live lanes (sentinel lanes iy0 >= NY —
    invalid particles and chunk padding — are excluded so they cannot
    drag the anchor); within one stripe x is sorted, so relx spans
    ~K/(H*density) columns. Lanes outside either window are handled by
    the caller's corrective pass.
    """
    ay = jnp.clip(jnp.min(ciy0), 0, NY - W)
    live = ciy0 < NY
    ax = jnp.clip(jnp.min(jnp.where(live, cix0, NX)), 0, NX - WX)
    rely = ciy0 - ay
    relx = cix0 - ax
    ok = ((rely >= 0) & (rely + my <= W)
          & (relx >= 0) & (relx + mx <= WX) & live)
    return ay, ax, rely, jnp.where(ok, relx, 0), ok


def _live_wide(ymc, xmc, order, deriv_type, NY, NX, W, WX):
    """(live, wide) masks over all (nchunk, K) lanes: live = real particle,
    wide = live but outside its chunk's banded window."""
    my = mx = _ntaps(order, deriv_type)
    if deriv_type < 0:
        iy0 = shape_weights(ymc, order)[0]
        ix0 = shape_weights(xmc, order)[0]
    else:
        iy0 = shape_weights_derivative(ymc, order, deriv_type)[0]
        ix0 = shape_weights_derivative(xmc, order, deriv_type)[0]
    ay = jnp.clip(jnp.min(iy0, axis=1), 0, NY - W)
    live = iy0 < NY
    ax = jnp.clip(jnp.min(jnp.where(live, ix0, NX), axis=1), 0, NX - WX)
    rely = iy0 - ay[:, None]
    relx = ix0 - ax[:, None]
    ok = ((rely >= 0) & (rely + my <= W)
          & (relx >= 0) & (relx + mx <= WX))
    return live, live & ~ok


def _elem_gather_chunk(stack, cym, cxm, order, deriv_type, main=False):
    """Wide-span fallback gather: elementwise stencil fetch from the full
    (NY, NX, C) stack for one chunk. With main=True also returns the
    nodal-derivative gathers of channel 0 (the Psi derivatives used by
    banded_gather_main)."""
    NYp, NXp, C = stack.shape
    ciy0, cwy, cdwy = _taps(cym, order, deriv_type)
    cix0, cwx, cdwx = _taps(cxm, order, deriv_type)
    my = cwy.shape[1]
    mx = cwx.shape[1]
    jy = jnp.clip(ciy0[:, None, None]
                  + jnp.arange(my, dtype=jnp.int32)[None, :, None],
                  0, NYp - 1)
    jx = jnp.clip(cix0[:, None, None]
                  + jnp.arange(mx, dtype=jnp.int32)[None, None, :],
                  0, NXp - 1)
    jy = jnp.broadcast_to(jy, (ciy0.size, my, mx))
    jx = jnp.broadcast_to(jx, (ciy0.size, my, mx))
    vals = stack[jy, jx, :]                                  # (K, my, mx, C)
    live = (ciy0 < NYp).astype(cwy.dtype)                    # sentinel lanes
    w = cwy[:, :, None] * cwx[:, None, :] * live[:, None, None]
    out = jnp.sum(w[..., None] * vals, axis=(1, 2))          # (K, C)
    if not main:
        return out
    psi = vals[..., 0]
    exmby = jnp.sum(cwy[:, :, None] * cdwx[:, None, :] * psi,
                    axis=(1, 2)) * live
    eypbx = jnp.sum(cdwy[:, :, None] * cwx[:, None, :] * psi,
                    axis=(1, 2)) * live
    return out, exmby, eypbx


def _scatter_deposit_chunk(acc, cym, cxm, cv, order, deriv_type,
                           ykind="w", xkind="w"):
    """Wide-span fallback: XLA scatter-add one chunk (values (K, C)) into
    the full field (C, NY, NX). Only taken (lax.cond in the sequential
    chunk scan) when a chunk's rows exceed the W window — e.g. sparse rows
    thinned by absorbing boundaries — so the banded fast path never drops
    contributions (ref SliceSort/DepositionUtil never drop either)."""
    C, NYp, NXp = acc.shape
    ciy0, wys, dwys = _taps(cym, order, deriv_type)
    cix0, wxs, dwxs = _taps(cxm, order, deriv_type)
    cwy = wys if ykind == "w" else dwys
    cwx = wxs if xkind == "w" else dwxs
    my = cwy.shape[1]
    mx = cwx.shape[1]
    jy_raw = ciy0[:, None, None] \
        + jnp.arange(my, dtype=jnp.int32)[None, :, None]
    jx_raw = cix0[:, None, None] \
        + jnp.arange(mx, dtype=jnp.int32)[None, None, :]
    # taps outside the padded array are DROPPED, not clamped (same
    # semantics as ops/deposit.py);
    # this also zeroes sentinel lanes (iy0 >= NYp)
    cwy = cwy * ((jy_raw >= 0) & (jy_raw < NYp))[:, :, 0]
    cwx = cwx * ((jx_raw >= 0) & (jx_raw < NXp))[:, 0, :]
    jy = jnp.clip(jy_raw, 0, NYp - 1)
    jx = jnp.clip(jx_raw, 0, NXp - 1)
    w = cwy[:, :, None] * cwx[:, None, :]                   # (K, my, mx)
    jy = jnp.broadcast_to(jy, w.shape)
    jx = jnp.broadcast_to(jx, w.shape)
    upd = w[None] * cv.T[:, :, None, None]                  # (C, K, my, mx)
    return acc.at[:, jy, jx].add(upd)


@partial(jax.jit, static_argnames=("NY", "NX", "order", "deriv_type",
                                   "ykind", "xkind", "W", "K", "WX"))
def banded_deposit(fields, ym, xm, values, NY, NX, order, W=16, K=512,
                   WX=None, deriv_type=-1, ykind="w", xkind="w"):
    """Deposit values (N, C) into fields (C, NY, NX) at cell positions
    ym/xm (guard-offset; invalid lanes >= 2*NY, sorted to the tail).

    deriv_type < 0 uses the plain order-p shapes; >= 0 the fused
    derivative stencils (ShapeFactors.H:203-466), with ykind/xkind
    selecting the shape ("w") or derivative ("dw") factor per axis.
    WX < NX enables 2D banding (requires the stripe-snake sort). Lanes
    outside a window are added exactly by the corrective pass, so nothing
    is dropped; lost_count is kept at 0 for API compatibility.
    Returns (fields, lost_count).
    """
    C = values.shape[1]
    N = ym.shape[0]
    nchunk = N // K
    my = mx = _ntaps(order, deriv_type)
    if not WX or WX > NX:  # 0/None disable 2D windows
        WX = NX

    ymc = ym.reshape(nchunk, K)
    xmc = xm.reshape(nchunk, K)
    vc = values.reshape(nchunk, K, C)

    def body(acc, chunk):
        cym, cxm, cv = chunk
        ciy0, wys, dwys = _taps(cym, order, deriv_type)
        cix0, wxs, dwxs = _taps(cxm, order, deriv_type)
        cwy = wys if ykind == "w" else dwys
        cwx = wxs if xkind == "w" else dwxs
        ay, ax, rely, relx, ok = _anchors2d(ciy0, cix0, my, mx, NY, NX,
                                            W, WX)
        Wy = _onehot_w(jnp.where(ok, rely, 0), cwy, W) \
            * ok[:, None].astype(cwy.dtype)
        # fold the (narrow) values into Wy, building the (W*C, K) operand
        # directly: the contraction is then the standard (M,K)@(K,N)
        # layout and the one-hot build stays fused into the dot
        WyVT = (Wy.T[:, None, :] * cv.T[None, :, :]).reshape(W * C, K)
        Wx = _onehot_w(relx, cwx, WX)                      # (K, WX)
        contrib = jax.lax.dot_general(
            WyVT, Wx, (((1,), (0,)), ((), ())),
            precision=_HI, preferred_element_type=acc.dtype)  # (W*C, WX)
        contrib = contrib.reshape(W, C, WX)
        zero = jnp.zeros((), ay.dtype)
        win = jax.lax.dynamic_slice(acc, (zero, ay, ax), (C, W, WX))
        acc = jax.lax.dynamic_update_slice(
            acc, win + jnp.transpose(contrib, (1, 0, 2)), (zero, ay, ax))
        return acc, None

    acc, _ = jax.lax.scan(body, fields, (ymc, xmc, vc))

    # corrective pass: contributions the window missed (chunks spanning
    # sparse rows/columns, e.g. under absorbing boundaries or across a
    # blown-out cavity) are added exactly via per-chunk scatter. A 0/1-trip
    # while_loop (never if-converted by XLA, unlike lax.cond around big
    # branches) keeps the common case free.
    live, wide = _live_wide(ymc, xmc, order, deriv_type, NY, NX, W, WX)
    dropped = wide & (jnp.abs(vc).sum(axis=2) > 0)         # (nchunk, K)

    def corrective(state):
        acc, _ = state

        def cbody(a, chunk):
            cym, cxm, cv, cdrop = chunk
            a = jax.lax.cond(
                jnp.any(cdrop),
                lambda aa: _scatter_deposit_chunk(
                    aa, cym, cxm, cv * cdrop[:, None].astype(cv.dtype),
                    order, deriv_type, ykind, xkind),
                lambda aa: aa, a)
            return a, None

        acc, _ = jax.lax.scan(cbody, acc, (ymc, xmc, vc, dropped))
        return acc, jnp.zeros((), bool)

    acc, _ = jax.lax.while_loop(
        lambda s: s[1], corrective, (acc, jnp.any(dropped)))
    return acc, jnp.zeros((), jnp.int32)


@partial(jax.jit, static_argnames=("NY", "NX", "order", "W", "K", "WX"))
def banded_gather(stack, ym, xm, NY, NX, order, W=16, K=512, WX=None):
    """Gather stack (NY, NX, C) at cell positions ym/xm -> (N, C).

    Same banding contract as banded_deposit. Out-of-window particles read
    zeros from the banded pass and are patched with the exact elementwise
    gather by the corrective pass.
    """
    C = stack.shape[2]
    N = ym.shape[0]
    nchunk = N // K
    my = mx = order + 1
    if not WX or WX > NX:  # 0/None disable 2D windows
        WX = NX

    ymc = ym.reshape(nchunk, K)
    xmc = xm.reshape(nchunk, K)

    def body(_, chunk):
        cym, cxm = chunk
        ciy0, cwy, _d = _taps(cym, order, -1)
        cix0, cwx, _d = _taps(cxm, order, -1)
        ay, ax, rely, relx, ok = _anchors2d(ciy0, cix0, my, mx, NY, NX,
                                            W, WX)
        Wy = _onehot_w(jnp.where(ok, rely, 0), cwy, W) \
            * ok[:, None].astype(cwy.dtype)
        zero = jnp.zeros((), ay.dtype)
        win = jax.lax.dynamic_slice(
            stack, (ay, ax, zero), (W, WX, C))
        # contract x FIRST: intermediate (K, W*C), never (K, WX*C)
        winx = jnp.transpose(win, (1, 0, 2)).reshape(WX, W * C)
        Wx = _onehot_w(relx, cwx, WX)                      # (K, WX)
        tmp = jax.lax.dot_general(
            Wx, winx, (((1,), (0,)), ((), ())),
            precision=_HI, preferred_element_type=win.dtype)  # (K, W*C)
        return None, jnp.sum(Wy[:, :, None] * tmp.reshape(K, W, C), axis=1)

    _, outs = jax.lax.scan(body, None, (ymc, xmc))

    # corrective pass: lanes outside the window read zeros above; a
    # 0/1-trip while_loop (real control flow — never if-converted by XLA,
    # unlike lax.cond around big branches) recomputes those lanes
    # elementwise and patches them in. Common case costs one predicate.
    live, wide_all = _live_wide(ymc, xmc, order, -1, NY, NX, W, WX)

    def corrective(state):
        outs, _ = state

        def cbody(_, chunk):
            cym, cxm, cwide, prev = chunk
            out = jax.lax.cond(
                jnp.any(cwide),
                lambda p: jnp.where(
                    cwide[:, None],
                    _elem_gather_chunk(stack, cym, cxm, order, -1), p),
                lambda p: p, prev)
            return None, out

        _, outs = jax.lax.scan(cbody, None, (ymc, xmc, wide_all, outs))
        return outs, jnp.zeros((), bool)

    outs, _ = jax.lax.while_loop(
        lambda s: s[1], corrective, (outs, jnp.any(wide_all)))
    return outs.reshape(N, C)


@partial(jax.jit, static_argnames=("NY", "NX", "order", "deriv_type",
                                   "ykinds", "W", "K", "WX"))
def banded_deposit_multi(fields, ym, xm, values, ykinds, NY, NX, order,
                         deriv_type, W=16, K=512, WX=None):
    """Deposit several y-weight/value sets sharing ONE x one-hot.

    The (K, WX) one-hot matrix is the per-chunk matmul cost of a banded
    deposit; any deposits with the same x factors should share it.
    values is (N, sum C_i); ykinds a static tuple of (kind, C_i) with
    kind in {"w", "dw"} selecting the y factor per channel block; fields
    is (sum C_i, NY, NX) with channel blocks in ykinds order.
    Returns (fields, lost).
    """
    C = fields.shape[0]
    N = ym.shape[0]
    nchunk = N // K
    my = mx = _ntaps(order, deriv_type)
    if not WX or WX > NX:  # 0/None disable 2D windows
        WX = NX

    ymc = ym.reshape(nchunk, K)
    xmc = xm.reshape(nchunk, K)
    vc = values.reshape(nchunk, K, C)

    def body(acc, chunk):
        cym, cxm, cv = chunk
        ciy0, wys, dwys = _taps(cym, order, deriv_type)
        cix0, wxs, dwxs = _taps(cxm, order, deriv_type)
        ay, ax, rely, relx, ok = _anchors2d(ciy0, cix0, my, mx, NY, NX,
                                            W, WX)
        relc = jnp.where(ok, rely, 0)
        okf = ok[:, None].astype(wxs.dtype)
        blocks = []
        off = 0
        for kind, ci in ykinds:
            Wy = _onehot_w(relc, wys if kind == "w" else dwys, W) * okf
            cvi = cv[:, off:off + ci]
            # (W*C_i, K) operand: standard (M,K)@(K,N) contraction keeps
            # the one-hot fused (see banded_deposit)
            blocks.append((Wy.T[:, None, :] * cvi.T[None, :, :]).reshape(
                W * ci, K))
            off += ci
        WyVT = jnp.concatenate(blocks, axis=0)             # (W*C, K)
        Wx = _onehot_w(relx, wxs, WX)                      # (K, WX)
        contrib = jax.lax.dot_general(
            WyVT, Wx, (((1,), (0,)), ((), ())),
            precision=_HI, preferred_element_type=acc.dtype)  # (W*C, WX)
        # block rows are (W, C_i)-ordered; bring to (C, W, WX)
        parts = []
        off = 0
        for kind, ci in ykinds:
            parts.append(jnp.transpose(
                contrib[off:off + W * ci].reshape(W, ci, WX), (1, 0, 2)))
            off += W * ci
        contrib = jnp.concatenate(parts, axis=0)
        zero = jnp.zeros((), ay.dtype)
        win = jax.lax.dynamic_slice(acc, (zero, ay, ax), (C, W, WX))
        acc = jax.lax.dynamic_update_slice(acc, win + contrib,
                                           (zero, ay, ax))
        return acc, None

    acc, _ = jax.lax.scan(body, fields, (ymc, xmc, vc))

    # corrective pass (see banded_deposit): scatter-add lanes the window
    # missed, in a 0/1-trip while_loop so the common case stays free.
    live, wide = _live_wide(ymc, xmc, order, deriv_type, NY, NX, W, WX)
    dropped = wide & (jnp.abs(vc).sum(axis=2) > 0)         # (nchunk, K)

    def corrective(state):
        acc, _ = state

        def cbody(a, chunk):
            cym, cxm, cv, cdrop = chunk

            def do(aa):
                off = 0
                for kind, ci in ykinds:
                    cvi = cv[:, off:off + ci] \
                        * cdrop[:, None].astype(cv.dtype)
                    aa = aa.at[off:off + ci].set(_scatter_deposit_chunk(
                        aa[off:off + ci], cym, cxm, cvi, order,
                        deriv_type, kind, "w"))
                    off += ci
                return aa

            a = jax.lax.cond(jnp.any(cdrop), do, lambda aa: aa, a)
            return a, None

        acc, _ = jax.lax.scan(cbody, acc, (ymc, xmc, vc, dropped))
        return acc, jnp.zeros((), bool)

    acc, _ = jax.lax.while_loop(
        lambda s: s[1], corrective, (acc, jnp.any(dropped)))
    return acc, jnp.zeros((), jnp.int32)


@partial(jax.jit, static_argnames=("NY", "NX", "order", "W", "K", "WX"))
def banded_gather_main(stack, ym, xm, NY, NX, order, W=16, K=512, WX=None):
    """Fused main-fields gather as one-hot products (banded variant of
    gather_main_fields, ref FieldGather.H:45-97).

    stack: (NY, NX, 5) with channel 0 = Psi, 1..4 = Ez, Bx, By, Bz.
    The nodal (deriv_type=1) shape and derivative factors are computed
    in-body from ym/xm. Returns (exmby_raw, eypbx_raw, ez, bx, by, bz,
    lost) where the caller multiplies the raw Psi derivatives by 1/dx,
    1/dy; out-of-window lanes are patched exactly by the corrective pass,
    so lost is kept at 0 for API compatibility.
    """
    N = ym.shape[0]
    nchunk = N // K
    my = mx = _ntaps(order, 1)
    if not WX or WX > NX:  # 0/None disable 2D windows
        WX = NX

    ymc = ym.reshape(nchunk, K)
    xmc = xm.reshape(nchunk, K)

    def body(_, chunk):
        cym, cxm = chunk
        ciy0, cwy, cdwy = _taps(cym, order, 1)
        cix0, cwx, cdwx = _taps(cxm, order, 1)
        ay, ax, rely, relx, okb = _anchors2d(ciy0, cix0, my, mx, NY, NX,
                                             W, WX)
        ok = okb.astype(cwy.dtype)[:, None]
        relc = jnp.where(okb, rely, 0)
        Wy = _onehot_w(relc, cwy, W) * ok
        dWy = _onehot_w(relc, cdwy, W) * ok
        zero = jnp.zeros((), ay.dtype)
        win = jax.lax.dynamic_slice(stack, (ay, ax, zero),
                                    (W, WX, 5))
        winx = jnp.transpose(win, (1, 0, 2)).reshape(WX, W * 5)
        Wx = _onehot_w(relx, cwx, WX)
        dWx = _onehot_w(relx, cdwx, WX)
        tmp = jax.lax.dot_general(
            Wx, winx, (((1,), (0,)), ((), ())),
            precision=_HI,
            preferred_element_type=win.dtype).reshape(K, W, 5)
        winx_psi = jnp.transpose(win[:, :, 0], (1, 0))      # (WX, W)
        tmp_dx = jax.lax.dot_general(
            dWx, winx_psi, (((1,), (0,)), ((), ())),
            precision=_HI, preferred_element_type=win.dtype)  # (K, W)
        # the nodal derivative factors already carry the ExmBy = -dxPsi
        # sign convention (same as ops/gather.py gather_main_fields)
        exmby = jnp.sum(Wy * tmp_dx, axis=1)
        eypbx = jnp.sum(dWy * tmp[:, :, 0], axis=1)
        rest = jnp.sum(Wy[:, :, None] * tmp[:, :, 1:], axis=1)  # (K, 4)
        return None, (exmby, eypbx, rest)

    _, (exmby, eypbx, rest) = jax.lax.scan(body, None, (ymc, xmc))

    # corrective pass (see banded_gather): patch out-of-window lanes with
    # the exact elementwise gather in a 0/1-trip while_loop.
    live, wide_all = _live_wide(ymc, xmc, order, 1, NY, NX, W, WX)

    def corrective(state):
        exmby, eypbx, rest, _ = state

        def cbody(_, chunk):
            cym, cxm, cwide, pe, pp, pr = chunk

            def patch(args):
                pe, pp, pr = args
                out, fe, fp = _elem_gather_chunk(stack, cym, cxm, order,
                                                 1, main=True)
                return (jnp.where(cwide, fe, pe),
                        jnp.where(cwide, fp, pp),
                        jnp.where(cwide[:, None], out[:, 1:], pr))

            out = jax.lax.cond(jnp.any(cwide), patch, lambda a: a,
                               (pe, pp, pr))
            return None, out

        _, (exmby, eypbx, rest) = jax.lax.scan(
            cbody, None, (ymc, xmc, wide_all, exmby, eypbx, rest))
        return exmby, eypbx, rest, jnp.zeros((), bool)

    exmby, eypbx, rest, _ = jax.lax.while_loop(
        lambda s: s[3], corrective,
        (exmby, eypbx, rest, jnp.any(wide_all)))
    rest = rest.reshape(N, 4)
    lost = jnp.zeros((), jnp.int32)
    return (exmby.reshape(N), eypbx.reshape(N),
            rest[:, 0], rest[:, 1], rest[:, 2], rest[:, 3], lost)
