#!/usr/bin/env python3
"""Per-op profile of the bench slice step on the current jax backend.

Runs one benchmark step under jax.profiler.trace and prints the top ops by
total device time from the captured Chrome-trace JSON — the analogue of
the reference's TinyProfiler tables (ref utils/HipaceProfilerWrapper.H).

Usage: python tools/trace_summary.py [trace_dir]   (default traces/slice)
Env: HIPACE_BENCH_NXY/NZ/NPART/HIPACE_BENCH_OVERRIDES as bench.py.
"""

from __future__ import annotations

import glob
import gzip
import json
import os
import sys
from collections import defaultdict


def summarize(trace_dir: str, top: int = 40):
    files = sorted(glob.glob(os.path.join(
        trace_dir, "plugins/profile/*/*.trace.json.gz")))
    if not files:
        print(f"no trace files under {trace_dir}")
        return
    with gzip.open(files[-1], "rt") as f:
        doc = json.load(f)
    events = doc.get("traceEvents", [])
    # device-side complete events: pid names naming a GPU or device
    pid_names = {}
    for e in events:
        if e.get("ph") == "M" and e.get("name") == "process_name":
            pid_names[e["pid"]] = e["args"].get("name", "")
    dev_pids = {p for p, n in pid_names.items()
                if "GPU" in n or "Device" in n or "/device:" in n}
    # self time: subtract directly-nested child events (per pid/tid lane)
    lanes = defaultdict(list)
    for e in events:
        if e.get("ph") == "X" and e.get("pid") in dev_pids:
            lanes[(e["pid"], e.get("tid"))].append(e)
    tot = defaultdict(float)
    cnt = defaultdict(int)
    src_tot = defaultdict(float)
    src_cnt = defaultdict(int)
    for lane in lanes.values():
        lane.sort(key=lambda e: (e["ts"], -e.get("dur", 0.0)))
        stack = []          # entries [end_ts, child_dur_acc, event]
        done = []
        for e in lane:
            ts, dur = e["ts"], e.get("dur", 0.0)
            while stack and ts >= stack[-1][0]:
                done.append(stack.pop())
            if stack:
                stack[-1][1] += dur
            stack.append([ts + dur, 0.0, e])
            cnt[e.get("name", "?")] += 1
        done.extend(stack)
        for end, child_dur, e in done:
            self_us = max(0.0, e.get("dur", 0.0) - child_dur)
            tot[e.get("name", "?")] += self_us
            src = e.get("args", {}).get("source", "?")
            src = src.replace("/root/repo/tools/../", "")
            src_tot[src] += self_us
            src_cnt[src] += 1
    items = sorted(tot.items(), key=lambda kv: -kv[1])
    total = sum(tot.values())
    print(f"{'op':60s} {'ms':>10s} {'count':>8s} {'%':>6s}")
    for name, us in items[:top]:
        print(f"{name[:60]:60s} {us / 1e3:10.2f} {cnt[name]:8d} "
              f"{100 * us / max(total, 1):6.1f}")
    print(f"{'TOTAL device':60s} {total / 1e3:10.2f}")
    # ---- grouped by python source line (from XLA op metadata)
    print(f"\n{'source line':60s} {'ms':>10s} {'count':>8s} {'%':>6s}")
    for src, us in sorted(src_tot.items(), key=lambda kv: -kv[1])[:top]:
        print(f"{src[-60:]:60s} {us / 1e3:10.2f} {src_cnt[src]:8d} "
              f"{100 * us / max(total, 1):6.1f}")


def main():
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    trace_dir = (sys.argv[1] if len(sys.argv) > 1
                 else os.path.join(repo, "traces", "slice"))
    import jax
    sys.path.insert(0, repo)
    import decks

    nxy = int(os.environ.get("HIPACE_BENCH_NXY", "1023"))
    nz = int(os.environ.get("HIPACE_BENCH_NZ", "32"))
    npart = int(os.environ.get("HIPACE_BENCH_NPART",
                               max(1024, int(nxy * nxy * 10 * nz / 1000))))
    extra = os.environ.get("HIPACE_BENCH_OVERRIDES", "")

    from hipace_tpu.parser import Inputs
    from hipace_tpu.pipeline.simulation import Simulation
    inputs = Inputs.from_file(
        decks.path("transverse_benchmark"),
        overrides=[
            f"my_constants.nxy={nxy}", f"amr.n_cell={nxy} {nxy} {nz}",
            f"beam.num_particles={npart}", "max_step=0", "hipace.dt=1.0",
            "diagnostic.output_period=0", "hipace.openpmd_backend=json",
        ] + ([o for o in extra.split(";") if o] if extra else []))
    sim = Simulation(inputs, verbose=0)
    res = sim.run_step(0)            # compile + warmup
    jax.block_until_ready(res["binned"])
    with jax.profiler.trace(trace_dir):
        sim.binned = res["binned"]
        res = sim.run_step(1)
        jax.block_until_ready(res["binned"])
    summarize(trace_dir)
    return 0


if __name__ == "__main__":
    sys.exit(main())
