"""Per-op timing breakdown of the hot slice step at bench shape.

Times each phase of the explicit-solver slice pipeline (sort, fused
deposit, gather+push, field solves, beam ops) individually on the live
backend, plus one full slice_step, so kernel work can be attributed.
Run on the GPU:  python tools/profile_slice.py [nxy]
"""

from __future__ import annotations

import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax
import jax.numpy as jnp

import decks


def timeit(name, fn, *args, n=3, k=8):
    """Best of n, each the mean of k back-to-back dispatches ended by
    block_until_ready (so the per-call host overhead is amortized)."""
    jax.block_until_ready(fn(*args))  # compile
    best = float("inf")
    for _ in range(n):
        t0 = time.perf_counter()
        out = None
        for _ in range(k):
            out = fn(*args)
        jax.block_until_ready(out)
        best = min(best, (time.perf_counter() - t0) / k)
    print(f"{name:36s} {best * 1e3:9.3f} ms")
    return best


def main():
    nxy = int(sys.argv[1]) if len(sys.argv) > 1 else 1023
    nz = 8
    from hipace_tpu.parser import Inputs
    from hipace_tpu.pipeline.simulation import Simulation
    from hipace_tpu.pipeline import step as stp
    from hipace_tpu.particles import plasma as pl
    from hipace_tpu.particles import beam as bm

    npart = max(1024, int(nxy * nxy * 10 * nz / 1000))
    inputs = Inputs.from_file(
        decks.path("transverse_benchmark"),
        overrides=[
            f"my_constants.nxy={nxy}",
            f"amr.n_cell={nxy} {nxy} {nz}",
            f"beam.num_particles={npart}",
            "max_step=0", "hipace.dt=1.0",
            "diagnostic.output_period=0", "hipace.openpmd_backend=json",
        ])
    sim = Simulation(inputs, verbose=0)
    cfg = sim.cfg
    g = sim.geom
    dtype = sim.dtype
    print(f"# nxy={nxy} plasma={g.nx * g.ny} beam_cap={sim.beam_cap} "
          f"device={jax.devices()[0].device_kind} "
          f"use_banded={int(cfg.use_banded)} W={cfg.banded_W}")

    key = jax.random.PRNGKey(0)
    plasmas = sim._init_plasma_state(key, 0.0)
    p = plasmas[0]
    pcfg = sim.plasma_cfgs[0]
    pc = sim.pc
    order = cfg.depos_order_xy
    banded = stp._banded_opts(cfg)
    banded_g = stp._banded_opts(cfg, gather=True)

    fields = stp.init_field_state(cfg, dtype)
    this = fields["This"]
    # non-trivial field content
    NY, NX = g.slice_shape
    ky = jnp.arange(NY, dtype=dtype)[:, None]
    kx = jnp.arange(NX, dtype=dtype)[None, :]
    wave = jnp.sin(0.01 * ky) * jnp.cos(0.013 * kx) * 1e-3
    for c in ("Psi", "Ez", "Bx", "By", "Bz", "ExmBy", "EypBx", "chi",
              "Sy", "Sx"):
        this = dict(this, **{c: wave})

    # ---- 1. row sort
    sort_fn = jax.jit(lambda pp: stp._row_sort(pp, g,
                                               stp.banded_stripe_h(cfg)))
    timeit("row_sort (stripe-snake)", sort_fn, p)
    ps = jax.block_until_ready(sort_fn(p))

    # ---- 2. fused deposit (main + Sx/Sy channels)
    comps = ["jx", "jy", "chi", "rhomjz"]

    @jax.jit
    def dep(pp, th):
        out, newp, dg = pl.fused_plasma_deposits(
            pp, comps, th, g, pcfg, pc, order, cfg.depos_derivative_type,
            cfg.normalized_units, False, banded)
        return out["jx"], dg

    timeit("fused plasma deposit (C=13)", dep, ps, this)

    # ---- 3. plasma advance (gather + push), 1 subcycle
    @jax.jit
    def adv(pp, th):
        return pl.advance_plasma(pp, th, g, pcfg, pc, temp_slice=False,
                                 order=order, banded=banded_g)["x"]

    timeit("advance_plasma (gather+push)", adv, ps, this)

    # gather alone
    @jax.jit
    def gat(pp, th):
        return pl._banded_main_gather(
            pp["x_prev"], pp["y_prev"], pp["valid"], th, g, order,
            banded_g)[0]

    timeit("banded gather_main alone", gat, ps, this)

    # ---- 4. Poisson (psi/ez/bz batched)
    solver = stp.make_poisson_solver(cfg.poisson_solver, g, dtype)

    @jax.jit
    def pois(th):
        return stp._solve_psi_ez_bz(th, cfg, solver, None)["Psi"]

    timeit("psi/ez/bz solve (batched DST)", pois, this)

    # ---- 5. MG BxBy
    from hipace_tpu.fields.multigrid import MultiGrid
    mg = MultiGrid(g.nx, g.ny, g.dx, g.dy, dtype)

    @jax.jit
    def mgs(th):
        return stp._explicit_bxby_solve(th, cfg, mg)[0]["Bx"]

    timeit("explicit MG BxBy solve", mgs, this)

    # ---- 6. beam ops
    binned = sim.binned
    bthis = {k: v[nz // 2] for k, v in binned.items() if k != "n_dropped"}

    @jax.jit
    def bdep(bt, th):
        return bm.deposit_beam_slice(bt, {"jz": "jz_beam"}, th, g,
                                     cfg.beams, pc, order,
                                     cfg.normalized_units)["jz_beam"]

    timeit("beam deposit jz (This)", bdep, bthis, this)

    @jax.jit
    def badv(bt, th):
        out = bm.advance_beam_slice(bt, th, g, cfg.beams[0], pc,
                                    jnp.asarray(1.0, dtype),
                                    jnp.asarray(-1e30, dtype),
                                    order=order)
        return out["x"]

    try:
        timeit("beam advance (subcycled)", badv, bthis, this)
    except Exception as e:
        print(f"beam advance: skipped ({type(e).__name__}: {e})")

    # ---- full slice step
    slice_step = stp.make_slice_step(cfg, dtype)
    beam_next = {k: jnp.zeros_like(v) for k, v in bthis.items()}
    from hipace_tpu.pipeline.step import empty_slip, zero_moments
    carry = {
        "fields": dict(fields, This=this),
        "plasma": [ps],
        "slip": empty_slip(cfg.slip_cap, dtype),
        "dt": jnp.asarray(1.0, dtype),
        "time": jnp.asarray(0.0, dtype),
        "min_uz": jnp.asarray(jnp.inf, dtype),
        "beam_moments": zero_moments(dtype),
        "step": jnp.asarray(0, jnp.int32),
    }
    xs = {"islice": jnp.asarray(nz // 2),
          "beam_this": bthis, "beam_next": beam_next}

    @jax.jit
    def one_slice(c, x):
        c2, ys = slice_step(c, x)
        return c2["plasma"][0]["x"]

    timeit("FULL slice_step", one_slice, carry, xs)


if __name__ == "__main__":
    main()
