"""Benchmark: zeta-slices/s on the reference's transverse benchmark deck.

Runs decks/transverse_benchmark (fixed_weight_pdf beam, 1 ppc plasma,
explicit solver) at nxy=1023, reduced to HIPACE_BENCH_NZ slices with the
beam particle count scaled to keep the deck's per-slice beam density
(nxy*nxy*10 per 1000 slices).

Prints the device (platform, kind, count, and the card's name and power
limit from nvidia-smi) and, as the last line, one JSON object: `value` is
zeta-slices/s, with ns/push (subcycles counted) and ns/cell — the
reference's end-of-run perf counters (ref Hipace.cpp:509-553). Fails on
any device other than a GPU.

Env overrides: HIPACE_BENCH_NXY (default 1023), HIPACE_BENCH_NZ (128),
HIPACE_BENCH_STEPS (4: 1 warmup+compile, 3 measured), HIPACE_BENCH_NPART,
HIPACE_BENCH_OVERRIDES (";"-separated deck overrides).
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

import jax

import decks


def main():
    devices = jax.devices()
    dev = devices[0]
    if dev.platform != "gpu":
        print(f"bench: needs a GPU, JAX found platform {dev.platform!r}",
              file=sys.stderr)
        return 1
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
        check=True).stdout.strip().splitlines()[0]
    print(f"# device: {dev.device_kind} x{len(devices)} ({dev.platform}); "
          f"{card}", file=sys.stderr)

    nxy = int(os.environ.get("HIPACE_BENCH_NXY", "1023"))
    nz = int(os.environ.get("HIPACE_BENCH_NZ", "128"))
    steps = int(os.environ.get("HIPACE_BENCH_STEPS", "4"))
    npart = int(os.environ.get("HIPACE_BENCH_NPART",
                               max(1024, int(nxy * nxy * 10 * nz / 1000))))

    from hipace_tpu.parser import Inputs
    from hipace_tpu.pipeline.simulation import Simulation

    extra = os.environ.get("HIPACE_BENCH_OVERRIDES", "")
    inputs = Inputs.from_file(
        decks.path("transverse_benchmark"),
        overrides=[
            f"my_constants.nxy={nxy}",
            f"amr.n_cell={nxy} {nxy} {nz}",
            f"beam.num_particles={npart}",
            "max_step=0", "hipace.dt=1.0",
            "diagnostic.output_period=0",
            "hipace.openpmd_backend=json",
        ] + [o for o in extra.split(";") if o])
    sim = Simulation(inputs, verbose=0)

    # warmup (compile)
    t0 = time.perf_counter()
    res = sim.run_step(0)
    jax.block_until_ready(res["binned"])
    compile_s = time.perf_counter() - t0

    t0 = time.perf_counter()
    measured = max(1, steps - 1)
    for s in range(measured):
        sim.binned = res["binned"]
        sim.time += float(sim.dt)
        res = sim.run_step(s + 1)
    jax.block_until_ready(res["binned"])
    wall = time.perf_counter() - t0

    n_slices = nz * measured
    # measured per-push / per-cell counters (subcycles counted,
    # ref Hipace.cpp:509-553)
    plasma_pushes = sum(sim.geom.nx * sim.geom.ny * p.ppc[0] * p.ppc[1]
                        * max(1, p.n_subcycles)
                        for p in sim.plasma_cfgs) * n_slices
    beam_pushes = sum((b.num_particles or 0) * max(1, b.n_subcycles)
                      for b in sim.beam_cfgs) * measured
    pushes = plasma_pushes + beam_pushes
    cells = sim.geom.nx * sim.geom.ny * n_slices
    # Bx/By solver iterations per slice of the last step (multigrid
    # V-cycles for the explicit solver)
    iters = [int(i) for i in res["bxby_iters"]]
    print(f"# first step (compile + run): {compile_s:.3f} s; measured: "
          f"{wall:.3f} s for {n_slices} slices ({plasma_pushes:.3g} plasma "
          f"+ {beam_pushes:.3g} beam pushes); use_banded="
          f"{int(sim.cfg.use_banded)}; Bx/By iterations per slice: mean "
          f"{sum(iters) / len(iters):.2f}, max {max(iters)}",
          file=sys.stderr)

    print(json.dumps({
        "metric": f"zeta-slices/s at {nxy}^2 transverse "
                  "(transverse_benchmark, pdf beam)",
        "value": n_slices / wall,
        "unit": "slices/s",
        "ns_per_push": 1e9 * wall / pushes,
        "ns_per_cell": 1e9 * wall / cells,
        "first_step_s": compile_s,
        "use_banded": bool(sim.cfg.use_banded),
        "bxby_iters_mean": sum(iters) / len(iters),
        "device": {"platform": dev.platform, "kind": dev.device_kind,
                   "count": len(devices), "card": card},
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
