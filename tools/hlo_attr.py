#!/usr/bin/env python3
"""Attribute device-trace op names (fusion.N ...) to Python source.

`tools/trace_summary.py` groups device time by the `source` arg of each
trace event, but big XLA fusions often carry no source there. This tool
closes that gap: it compiles the SAME bench step,
dumps the compiled HLO (which records op_name/source_file/source_line
metadata per fused instruction), and prints, for each requested op name,
the fused computation's source-line histogram weighted by instruction
output bytes (a static cost proxy).

The analogue of reading the reference's nvprof kernel names back to
TinyProfiler regions (ref utils/HipaceProfilerWrapper.H).

Usage (shapes/env as bench.py):
  python tools/hlo_attr.py fusion.27 fusion.1      # attribute these ops
  python tools/hlo_attr.py --dump hlo.txt          # just dump HLO text
"""

from __future__ import annotations

import os
import re
import sys
from collections import defaultdict

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

_SHAPE_RE = re.compile(r"(f64|f32|bf16|f16|s32|u32|s8|u8|pred|s64|u64)\[([0-9,]*)\]")
_META_RE = re.compile(
    r'metadata={[^}]*?op_name="([^"]*)"[^}]*?'
    r'source_file="([^"]*)"[^}]*?source_line=(\d+)')
_CALLS_RE = re.compile(r"calls=%?([\w.\-]+)")
_DTBYTES = {"f64": 8, "s64": 8, "u64": 8, "f32": 4, "s32": 4, "u32": 4,
            "bf16": 2, "f16": 2, "s8": 1, "u8": 1, "pred": 1}


def _out_bytes(line: str) -> int:
    """Bytes of the first (= output) shape on an HLO instruction line."""
    m = _SHAPE_RE.search(line)
    if not m:
        return 0
    n = 1
    for d in m.group(2).split(","):
        if d.strip():
            n *= int(d)
    return n * _DTBYTES.get(m.group(1), 4)


def parse_hlo(text: str):
    """-> (op->computation map for fusions/calls,
           computation -> [(src, op_tail, bytes), ...])"""
    op2comp = {}
    comp_lines = defaultdict(list)
    comp = None
    for line in text.splitlines():
        s = line.strip()
        if s.endswith("{") and ("(" in s) and ("->" in s or s.startswith("%")):
            # computation header: `%fused_computation.27 (param_0: ...) -> ... {`
            name = s.split()[0].lstrip("%")
            if not s.startswith(("ENTRY", "while", "cond", "body")):
                comp = name
            else:
                comp = s.split()[1].lstrip("%") if s.startswith("ENTRY") else name
            continue
        if s == "}":
            comp = None
            continue
        if comp is None or "=" not in s:
            continue
        opname = s.split("=", 1)[0].strip().lstrip("%")
        cm = _CALLS_RE.search(s)
        if cm:
            op2comp[opname] = cm.group(1)
        mm = _META_RE.search(s)
        if mm:
            op_name, src_file, src_line = mm.groups()
            src_file = src_file.split("/root/repo/")[-1]
            comp_lines[comp].append(
                (f"{src_file}:{src_line}", op_name.split("/")[-1],
                 _out_bytes(s)))
    return op2comp, comp_lines


def attribute(op2comp, comp_lines, op: str, top: int = 12,
              _depth: int = 0):
    """Print the source-line histogram for one op (recursing through
    nested calls like while bodies one level deep)."""
    comp = op2comp.get(op, op)
    rows = comp_lines.get(comp, [])
    if not rows and _depth == 0:
        # maybe it IS a computation name already, or has a .clone suffix
        comp = op2comp.get(op.split(".clone")[0], comp)
        rows = comp_lines.get(comp, [])
    agg_b = defaultdict(int)
    agg_n = defaultdict(int)
    ops_seen = defaultdict(set)
    for src, tail, b in rows:
        agg_b[src] += b
        agg_n[src] += 1
        if len(ops_seen[src]) < 3:
            ops_seen[src].add(tail)
    print(f"\n== {op} -> {comp} ({len(rows)} instructions)")
    for src, b in sorted(agg_b.items(), key=lambda kv: -kv[1])[:top]:
        print(f"  {src[-68:]:68s} {b / 1e6:10.1f} MB out "
              f"x{agg_n[src]:<5d} {','.join(sorted(ops_seen[src]))[:40]}")


def compiled_text():
    import jax
    import jax.numpy as jnp  # noqa: F401

    import decks
    from hipace_tpu.parser import Inputs
    from hipace_tpu.pipeline.simulation import Simulation

    nxy = int(os.environ.get("HIPACE_BENCH_NXY", "1023"))
    nz = int(os.environ.get("HIPACE_BENCH_NZ", "32"))
    npart = int(os.environ.get("HIPACE_BENCH_NPART",
                               max(1024, int(nxy * nxy * 10 * nz / 1000))))
    extra = os.environ.get("HIPACE_BENCH_OVERRIDES", "")
    inputs = Inputs.from_file(
        decks.path("transverse_benchmark"),
        overrides=[
            f"my_constants.nxy={nxy}", f"amr.n_cell={nxy} {nxy} {nz}",
            f"beam.num_particles={npart}", "max_step=0", "hipace.dt=1.0",
            "diagnostic.output_period=0", "hipace.openpmd_backend=json",
        ] + ([o for o in extra.split(";") if o] if extra else []))
    sim = Simulation(inputs, verbose=0)
    lowered = sim._step_fn.lower(
        sim.binned, jnp.asarray(sim.time, sim.dtype),
        jnp.asarray(sim.dt, sim.dtype), jax.random.PRNGKey(0),
        jnp.asarray(0, jnp.int32), sim.laser_stream)
    return lowered.compile().as_text()


def main():
    args = [a for a in sys.argv[1:]]
    dump = None
    if "--dump" in args:
        dump = args[args.index("--dump") + 1]
        del args[args.index("--dump"):args.index("--dump") + 2]
    src = None
    if "--from" in args:
        src = args[args.index("--from") + 1]
        del args[args.index("--from"):args.index("--from") + 2]
    text = open(src).read() if src else compiled_text()
    if dump:
        with open(dump, "w") as f:
            f.write(text)
        print(f"# wrote {len(text) / 1e6:.1f} MB HLO to {dump}")
    op2comp, comp_lines = parse_hlo(text)
    if not args:
        # default: the 10 fattest fused computations by total output bytes
        sizes = {c: sum(b for _, _, b in rows)
                 for c, rows in comp_lines.items()}
        args = [c for c, _ in sorted(sizes.items(),
                                     key=lambda kv: -kv[1])[:10]]
    for op in args:
        attribute(op2comp, comp_lines, op)
    return 0


if __name__ == "__main__":
    sys.exit(main())
