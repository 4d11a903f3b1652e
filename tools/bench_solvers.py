"""Time the per-slice field solves on the GPU at the benchmark width.

- The 3-channel Psi/Ez/Bz Dirichlet DST solve, "fast" (same-size rfft,
  the reference's FFTDirichletFast) against "expanded" (odd extension).
- The 2-channel Bx/By multigrid solve (explicit solver): milliseconds per
  V-cycle and the fixed cost of a solve, from solves forced to run exactly
  1 and 5 V-cycles (tol 0). The V-cycles a real slice takes are printed by
  bench.py (Bx/By iterations per slice); ms/slice = fixed + cycles x
  per-cycle. chi and the source are synthetic: a plasma of density 1
  (chi = 1) with a blown-out cavity of radius 2 (chi = 0), and smooth
  sources around the cavity edge.

Usage: python tools/bench_solvers.py [nxy] [reps]   (default 1023, 20)
Prints one JSON line per measurement; fails off the GPU.
"""

from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax
import jax.numpy as jnp
import numpy as np


def timed(fn, args, reps):
    """Median wall seconds of fn(*args) over reps (after a warmup call)."""
    jax.block_until_ready(fn(*args))
    ts = []
    for _ in range(reps):
        t0 = time.perf_counter()
        jax.block_until_ready(fn(*args))
        ts.append(time.perf_counter() - t0)
    return statistics.median(ts), ts


def main(argv):
    nxy = int(argv[1]) if len(argv) > 1 else 1023
    reps = int(argv[2]) if len(argv) > 2 else 20
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        print(f"bench_solvers: needs a GPU, found {dev.platform!r}",
              file=sys.stderr)
        return 1
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    from hipace_tpu.fields.multigrid import MultiGrid
    from hipace_tpu.fields.poisson import DirichletPoissonSolver

    dx = 16.0 / nxy
    rng = np.random.default_rng(0)
    tag = {"nxy": nxy, "device": dev.device_kind, "card": card,
           "dtype": "float32"}

    rhs = jnp.asarray(rng.standard_normal((3, nxy, nxy)), jnp.float32)
    for variant in ("fast", "expanded"):
        s = DirichletPoissonSolver(nxy, nxy, dx, dx, jnp.float32,
                                   variant=variant)
        med, ts = timed(jax.jit(s.solve), (rhs,), reps)
        print(json.dumps(dict(tag, what=f"dst_{variant}_3ch",
                              ms_median=1e3 * med,
                              ms_all=[1e3 * t for t in ts])))

    c = (np.arange(nxy) + 0.5) * dx - 8.0
    r = np.hypot(c[None, :], c[:, None])
    chi = jnp.asarray(np.where(r < 2.0, 0.0, 1.0), jnp.float32)
    edge = np.exp(-((r - 2.0) / 0.3) ** 2)
    src = np.stack([edge * c[None, :] / np.maximum(r, dx),
                    edge * c[:, None] / np.maximum(r, dx)])
    rhs = jnp.asarray(src, jnp.float32)
    mg = MultiGrid(nxy, nxy, dx, dx, jnp.float32)
    zero = jnp.zeros_like(rhs)
    med = {}
    for n in (1, 5):
        solve = jax.jit(lambda u0, b, a, n=n: mg.solve_info(
            u0, b, a, tol_rel=0.0, max_iters=n))
        med[n], ts = timed(solve, (zero, rhs, chi), reps)
        print(json.dumps(dict(tag, what=f"mg_bxby_2ch_{n}_vcycles",
                              ms_median=1e3 * med[n],
                              ms_all=[1e3 * t for t in ts])))
    per = (med[5] - med[1]) / 4
    print(json.dumps(dict(tag, what="mg_bxby_2ch_per_vcycle",
                          ms=1e3 * per, fixed_ms=1e3 * (med[1] - per))))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv))
