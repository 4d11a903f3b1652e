"""Discrete sine transforms (DST-I) built on XLA's batched FFT.

The reference implements DST-I Poisson solves three ways (Direct/Expanded/
Fast, ref: src/fields/fft_poisson_solver/). Two are here:
the odd-extension approach (the reference's "Expanded" variant,
ref: FFTPoissonSolverDirichletExpanded.cpp): a DST-I of length N equals the
imaginary part of a length-2(N+1) real FFT of the odd extension; and the
same-size "Fast" variant (dst1_fast). For the recommended sizes
N = 2^k - 1 both FFT lengths are powers of two.

DST-I here is the plain sine sum (no normalization):
    X[k] = sum_{n=0}^{N-1} x[n] sin(pi (n+1)(k+1) / (N+1))
so that dst1(dst1(x)) = (N+1)/2 * x.
"""

from __future__ import annotations

import jax.numpy as jnp


def dst1(x: jnp.ndarray, axis: int = -1) -> jnp.ndarray:
    """DST-I along `axis` via odd extension + rfft.

    Output dtype matches input dtype (the FFT runs in complex float of the
    input's precision).
    """
    x = jnp.moveaxis(x, axis, -1)
    n = x.shape[-1]
    shape = x.shape[:-1]
    zeros = jnp.zeros(shape + (1,), dtype=x.dtype)
    # odd extension: [0, x0..x_{n-1}, 0, -x_{n-1}..-x0], length 2(n+1)
    ext = jnp.concatenate([zeros, x, zeros, -x[..., ::-1]], axis=-1)
    spec = jnp.fft.rfft(ext, axis=-1)
    out = -0.5 * spec.imag[..., 1:n + 1]
    out = out.astype(x.dtype)
    return jnp.moveaxis(out, -1, axis)


def dst1_fast(x: jnp.ndarray, axis: int = -1) -> jnp.ndarray:
    """DST-I via a SAME-size real FFT (the reference's "Fast" variant,
    ref FFTPoissonSolverDirichletFast.cpp:24-140; Numerical-Recipes sinft):
    an auxiliary sequence of length N+1 is built with sine/difference
    twiddles, one rfft gives the odd outputs as -Im and the even outputs as
    a prefix sum of Re. Requires N+1 even (the recommended 2^k - 1 sizes).
    Half the FFT length of the odd-extension approach.
    """
    x = jnp.moveaxis(x, axis, -1)
    n = x.shape[-1]
    m = n + 1
    assert m % 2 == 0, "dst1_fast needs an odd length (2^k - 1 preferred)"
    j = jnp.arange(1, m)
    sin_j = jnp.sin(j * (jnp.pi / m)).astype(x.dtype)
    xr = x[..., ::-1]
    y1 = sin_j * (x + xr) + 0.5 * (x - xr)
    y = jnp.concatenate([jnp.zeros(x.shape[:-1] + (1,), x.dtype), y1],
                        axis=-1)
    Y = jnp.fft.rfft(y, axis=-1)                       # (..., m//2 + 1)
    odd = -Y.imag[..., 1:]                             # S1, S3, ..., S_{n-1}?
    re = Y.real
    even = jnp.cumsum(
        jnp.concatenate([0.5 * re[..., :1], re[..., 1:-1]], axis=-1),
        axis=-1)                                       # S0, S2, ...
    out = jnp.stack([even, odd[..., : even.shape[-1]]], axis=-1)
    out = out.reshape(x.shape[:-1] + (even.shape[-1] * 2,))[..., :n]
    out = out.astype(x.dtype)
    return jnp.moveaxis(out, -1, axis)


def dst1_2d(x: jnp.ndarray) -> jnp.ndarray:
    """DST-I along the last two axes (y, x)."""
    return dst1(dst1(x, axis=-1), axis=-2)


def dst1_2d_fast(x: jnp.ndarray) -> jnp.ndarray:
    """Fast-variant DST-I along the last two axes."""
    return dst1_fast(dst1_fast(x, axis=-1), axis=-2)


def idst1_2d(x: jnp.ndarray) -> jnp.ndarray:
    """Inverse 2D DST-I: same transform scaled by 4/((ny+1)(nx+1))."""
    ny, nx = x.shape[-2], x.shape[-1]
    return dst1_2d(x) * (4.0 / ((ny + 1) * (nx + 1)))
