"""Banded one-hot kernels vs the exact elementwise deposit/gather.

fp64 on the CPU mesh: the banded kernels must equal the elementwise
scatter/gather to roundoff — for every shape order, the derivative shape
factors, the multi-block deposits, lanes outside their chunk's window
(corrective pass: clumped columns, post-sort y drift), invalid-lane
sentinels, and against the plain scatter-add path of ops/deposit.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from hipace_tpu.geometry import Geometry
from hipace_tpu.ops.banded import (BandedOpts, banded_deposit,
                                   banded_deposit_multi, banded_gather_main,
                                   dispatch_deposit_blocks)
from hipace_tpu.ops.deposit import deposit_multi
from hipace_tpu.ops.shape import shape_weights, shape_weights_derivative

G = 3


def _make_particles(key, N, NY, NX, h, n_invalid=0, clump=False):
    """Stripe-snake sorted guard-offset cell positions on an (NY, NX)
    padded grid; invalid lanes carry the sentinel and sort to the tail."""
    kx, ky = jax.random.split(jax.random.PRNGKey(key))
    if clump:
        # extreme density gradient: half the particles in a thin column
        # (forces window overflow -> corrective pass)
        x1 = jax.random.uniform(kx, (N // 2,), jnp.float64, G, NX - G - 1.0)
        x2 = jax.random.uniform(ky, (N - N // 2,), jnp.float64, G, G + 2.0)
        x = jnp.concatenate([x1, x2])
        y = jax.random.uniform(jax.random.fold_in(ky, 1), (N,), jnp.float64,
                               G, NY - G - 1.0)
    else:
        x = jax.random.uniform(kx, (N,), jnp.float64, G, NX - G - 1.0)
        y = jax.random.uniform(ky, (N,), jnp.float64, G, NY - G - 1.0)
    valid = jnp.arange(N) < (N - n_invalid)
    x = jnp.where(valid, x, 2.0 * NX)
    y = jnp.where(valid, y, 2.0 * NY)
    # stripe-snake sort (mirrors pipeline/step.py _row_sort)
    col = jnp.clip(jnp.floor(x).astype(jnp.int32), 0, NX)
    row = jnp.clip(jnp.floor(y).astype(jnp.int32), 0, NY)
    stripe = jnp.where(valid, row // h, NY)
    colkey = jnp.where(stripe % 2 == 0, col, NX - col)
    keyv = stripe * (NX + 2) + colkey
    _, x, y = jax.lax.sort([keyv, x, y], num_keys=1)
    return y, x


def _drift_particles(NY, NX, N, h, seed):
    """Sorted particles with post-sort y drift: ~6% of lanes jump 30-60
    rows (sheath-crossing scale), the rest wobble — the drift a sort
    period > 1 leaves behind."""
    ym, xm = _make_particles(seed, N, NY, NX, h)
    k1, k2, k3 = jax.random.split(jax.random.PRNGKey(seed + 6), 3)
    live = ym < 1.5 * NY
    jump = (jax.random.uniform(k1, (N,)) < 0.06) & live
    dy = jnp.where(jump,
                   jax.random.uniform(k2, (N,), jnp.float64, 30.0, 60.0)
                   * jnp.sign(jax.random.normal(k3, (N,))),
                   jax.random.normal(k2, (N,)) * 0.3)
    return jnp.where(live, jnp.clip(ym + dy, 3.0, NY - 4.0), ym), xm


def _factors(c, order, deriv_type):
    if deriv_type < 0:
        i0, w = shape_weights(c, order)
        return i0, w, w
    return shape_weights_derivative(c, order, deriv_type)


def _exact_deposit(ym, xm, vals_nc, NY, NX, order, deriv_type=-1,
                   ykind="w", xkind="w"):
    """Elementwise scatter reference."""
    C = vals_nc.shape[1]
    iy0, wy, dwy = _factors(ym, order, deriv_type)
    ix0, wx, dwx = _factors(xm, order, deriv_type)
    cy = wy if ykind == "w" else dwy
    cx = wx if xkind == "w" else dwx
    m = cy.shape[1]
    live = (iy0 < NY).astype(vals_nc.dtype)
    out = jnp.zeros((C, NY, NX), vals_nc.dtype)
    for a in range(m):
        for b in range(m):
            w = cy[:, a] * cx[:, b] * live
            jy = jnp.clip(iy0 + a, 0, NY - 1)
            jx = jnp.clip(ix0 + b, 0, NX - 1)
            out = out.at[:, jy, jx].add(w * vals_nc.T)
    return out


def _exact_gather_main(stack_cm, ym, xm, order):
    """Elementwise main-fields gather: (exmby_raw, eypbx_raw, Ez, Bx, By,
    Bz) with the nodal (deriv_type=1) factors, like banded_gather_main."""
    NY, NX = stack_cm.shape[1:]
    iy0, wy, dwy = shape_weights_derivative(ym, order, 1)
    ix0, wx, dwx = shape_weights_derivative(xm, order, 1)
    m = wy.shape[1]
    live = (iy0 < NY).astype(stack_cm.dtype)
    jy = jnp.clip(iy0[:, None] + jnp.arange(m), 0, NY - 1)    # (N, m)
    jx = jnp.clip(ix0[:, None] + jnp.arange(m), 0, NX - 1)
    vals = stack_cm[:, jy[:, :, None], jx[:, None, :]]        # (5, N, m, m)
    w = wy[:, :, None] * wx[:, None, :] * live[:, None, None]
    rest = jnp.sum(w[None] * vals[1:], axis=(2, 3))           # (4, N)
    exmby = jnp.sum(wy[:, :, None] * dwx[:, None, :] * vals[0],
                    axis=(1, 2)) * live
    eypbx = jnp.sum(dwy[:, :, None] * wx[:, None, :] * vals[0],
                    axis=(1, 2)) * live
    return (exmby, eypbx, rest[0], rest[1], rest[2], rest[3])


def _close(got, ref, rtol=1e-12, atol=1e-12):
    np.testing.assert_allclose(np.asarray(got), np.asarray(ref),
                               rtol=rtol, atol=atol)


@pytest.mark.parametrize("order", [0, 1, 2, 3])
def test_banded_deposit_orders_match_exact(order):
    NY, NX = 70, 70
    N, h = 4096, 12
    ym, xm = _make_particles(3, N, NY, NX, h, n_invalid=100)
    vals = jnp.stack([jnp.ones(N, jnp.float64), xm * 0.01, ym * 0.02],
                     axis=-1)
    F0 = jnp.zeros((3, NY, NX), jnp.float64)
    got, lost = banded_deposit(F0, ym, xm, vals, NY, NX, order,
                               W=32, K=512)
    _close(got, _exact_deposit(ym, xm, vals, NY, NX, order))
    assert int(lost) == 0


@pytest.mark.parametrize("deriv_type,ykind,xkind", [
    (0, "w", "dw"), (1, "dw", "w"), (2, "w", "dw"), (2, "dw", "w")])
def test_banded_deposit_derivative_kinds_match_exact(deriv_type, ykind,
                                                     xkind):
    NY, NX = 70, 70
    N, h, order = 2048, 12, 2
    ym, xm = _make_particles(5, N, NY, NX, h, n_invalid=32)
    vals = jnp.stack([jnp.sin(xm), jnp.cos(ym)], axis=-1)
    F0 = jnp.zeros((2, NY, NX), jnp.float64)
    got, _ = banded_deposit(F0, ym, xm, vals, NY, NX, order, W=32, K=512,
                            deriv_type=deriv_type, ykind=ykind,
                            xkind=xkind)
    _close(got, _exact_deposit(ym, xm, vals, NY, NX, order, deriv_type,
                               ykind, xkind))


@pytest.mark.parametrize("order", [0, 1, 2, 3])
def test_banded_deposit_matches_scatter_add(order):
    """One-hot banded deposit == the plain scatter-add deposit
    (ops/deposit.py) on the same physical particles."""
    g = Geometry(n_cell=(64, 48, 8), prob_lo=(-8, -6, -2), prob_hi=(8, 6, 2),
                 nguards=3)
    NY, NX = g.slice_shape
    N = 4096
    ym, xm = _make_particles(13 + order, N, NY, NX, 12, n_invalid=64)
    live = ym < NY
    x = jnp.where(live, (xm - g.nguards) * g.dx + g.x_pos_offset, 0.0)
    y = jnp.where(live, (ym - g.nguards) * g.dy + g.y_pos_offset, 0.0)
    v = [jnp.where(live, 1.0, 0.0), jnp.where(live, jnp.sin(x), 0.0)]
    F0 = jnp.zeros((2, NY, NX), jnp.float64)
    ref = deposit_multi(F0, x, y, v, g, order)
    got, _ = banded_deposit(F0, ym, xm, jnp.stack(v, axis=-1), NY, NX,
                            order, W=32, K=512)
    _close(got, ref)


def test_banded_deposit_corrective_pass_clumped():
    """Extreme density gradient: many lanes overflow their window; the
    corrective pass must still make the result exact."""
    NY, NX = 134, 134
    N, order = 8192, 2
    ym, xm = _make_particles(7, N, NY, NX, 12, clump=True)
    vals = jnp.stack([jnp.ones(N, jnp.float64), xm + ym], axis=-1)
    F0 = jnp.zeros((2, NY, NX), jnp.float64)
    got, _ = banded_deposit(F0, ym, xm, vals, NY, NX, order, W=32, K=1024,
                            WX=64)
    _close(got, _exact_deposit(ym, xm, vals, NY, NX, order))


def test_banded_deposit_y_drift():
    """Post-sort y drift: lanes far outside their chunk's row window go
    through the corrective pass, with an exact result."""
    NY, NX = 134, 134
    N, order = 8192, 2
    ym, xm = _drift_particles(NY, NX, N, 12, seed=43)
    vals = jnp.stack([jnp.ones(N, jnp.float64), xm + ym, jnp.cos(ym)],
                     axis=-1)
    F0 = jnp.zeros((3, NY, NX), jnp.float64)
    got, _ = banded_deposit(F0, ym, xm, vals, NY, NX, order, W=32, K=1024)
    _close(got, _exact_deposit(ym, xm, vals, NY, NX, order), rtol=1e-10)


def test_banded_deposit_multi_matches_exact():
    NY, NX = 70, 70
    N, order, dt = 4096, 2, 1
    ym, xm = _make_particles(11, N, NY, NX, 12, n_invalid=64)
    vals = jnp.stack([jnp.ones(N, jnp.float64), xm, ym, xm * ym, xm - ym],
                     axis=-1)
    F0 = jnp.zeros((5, NY, NX), jnp.float64)
    got, _ = banded_deposit_multi(F0, ym, xm, vals, (("w", 3), ("dw", 2)),
                                  NY, NX, order, dt, W=32, K=512)
    ref = jnp.concatenate([
        _exact_deposit(ym, xm, vals[:, :3], NY, NX, order, dt, "w", "w"),
        _exact_deposit(ym, xm, vals[:, 3:], NY, NX, order, dt, "dw", "w")])
    _close(got, ref)


def test_dispatch_deposit_blocks_xla():
    """The blocks dispatcher's decomposition (shared-x multi deposit plus
    per-block deposits) must equal the exact deposits."""
    NY, NX = 70, 70
    N, order, dt = 2048, 2, 1
    ym, xm = _make_particles(37, N, NY, NX, 12, n_invalid=32)
    vals = [jnp.ones(N, jnp.float64), xm, ym, xm * ym, xm - ym]
    blocks = (("w", "w", 2), ("dw", "w", 1), ("w", "dw", 2))
    opts = BandedOpts(W=4096, K=1024)
    F0 = jnp.zeros((5, NY, NX), jnp.float64)
    got, _ = dispatch_deposit_blocks(F0, ym, xm, vals, blocks, opts,
                                     NY, NX, order, dt)
    v = jnp.stack(vals, axis=-1)
    ref = jnp.concatenate([
        _exact_deposit(ym, xm, v[:, :2], NY, NX, order, dt, "w", "w"),
        _exact_deposit(ym, xm, v[:, 2:3], NY, NX, order, dt, "dw", "w"),
        _exact_deposit(ym, xm, v[:, 3:], NY, NX, order, dt, "w", "dw")])
    _close(got, ref)


@pytest.mark.parametrize("order", [0, 1, 2, 3])
def test_banded_gather_main_orders_match_exact(order):
    NY, NX = 70, 70
    N = 4096
    ym, xm = _make_particles(17, N, NY, NX, 12, n_invalid=128)
    stack_cm = jax.random.normal(jax.random.PRNGKey(17), (5, NY, NX),
                                 jnp.float64)
    got = banded_gather_main(jnp.moveaxis(stack_cm, 0, -1), ym, xm, NY, NX,
                             order, W=32, K=512)
    for g_, r in zip(got[:6], _exact_gather_main(stack_cm, ym, xm, order)):
        _close(g_, r, rtol=1e-10)
    assert int(got[6]) == 0


@pytest.mark.parametrize("drift", [False, True], ids=["clumped", "y_drift"])
def test_banded_gather_main_corrective_pass(drift):
    """Lanes outside their window (clumped columns under a 2D window, or
    post-sort y drift) are patched exactly by the corrective pass."""
    NY, NX = 134, 134
    N, order = 8192, 2
    if drift:
        ym, xm = _drift_particles(NY, NX, N, 12, seed=31)
    else:
        ym, xm = _make_particles(19, N, NY, NX, 12, clump=True)
    stack_cm = jax.random.normal(jax.random.PRNGKey(23), (5, NY, NX),
                                 jnp.float64)
    got = banded_gather_main(jnp.moveaxis(stack_cm, 0, -1), ym, xm, NY, NX,
                             order, W=32, K=1024, WX=0 if drift else 64)
    for g_, r in zip(got[:6], _exact_gather_main(stack_cm, ym, xm, order)):
        _close(g_, r, rtol=1e-10)


def test_banded_plasma_padded_to_chunk_multiple():
    """Plasma arrays whose count is not a multiple of the chunk size get
    invalid pad lanes so every banded kernel sees whole K-chunks."""
    from hipace_tpu.parser import Inputs
    from hipace_tpu.pipeline.simulation import Simulation
    deck = """
    amr.n_cell = 30 30 4
    hipace.normalized_units = 1
    geometry.prob_lo = -4. -4. -2.
    geometry.prob_hi = 4. 4. 2.
    beams.names = no_beam
    plasmas.names = plasma
    plasma.density(x,y,z) = 1.
    plasma.ppc = 1 1
    diagnostic.output_period = 0
    hipace.use_banded = 1
    hipace.banded_K = 256
    hipace.banded_gather_K = 512
    """
    sim = Simulation(Inputs(deck), verbose=0)
    n = 30 * 30
    assert sim.cfg.plasma_pad == ((-n) % 512,)
    st = sim._init_plasma_state(jax.random.PRNGKey(0), 0.0)[0]
    assert st["x"].shape[0] % 512 == 0
    assert int(jnp.sum(st["valid"])) == n
