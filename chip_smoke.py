"""Smoke test of hipace_tpu on one CUDA GPU.

Runs the program's main path through its entry points on the card and
checks what comes out, in one process that opens the card once:

1. device: the platform must be "gpu"; prints the card, its power limit
   and the compilation cache in use.
2. main path: ``hipace_tpu.__main__.main`` on decks/transverse_benchmark at
   its full 1023^2 transverse width, reduced from 1000 to 128 slices (and
   the beam to the same per-slice density) for run time, 4 time steps.
   Prints compile seconds, steady step seconds, slices/s, ns/push, ns/cell
   and peak device memory; checks that every written field is finite, that
   on-axis Ez behind the driver is non-zero, and that no banded-window
   warning was printed.
3. kernels at real widths, f32 on the card against an f64 reference of the
   same inputs computed on the card: the plasma deposit (scatter-add and
   one-hot banded; 1023^2, ~1M particles, 13 channels, orders 0-3), the
   fused 6-field gather (both paths), the 3-channel DST solve (both
   variants) and the 2-channel multigrid solve.
4. physics: decks/blowout_wake/inputs_normalized at 255^2 x 100, one
   time step in f32 against f64 on the card, field and beam sums within
   F32_BOUND (tests/test_f32_physics.py), each field component measured
   against its field's largest sum.

``--four`` runs only phase 5: Simulation.evolve_pipelined() over four cards
against serial evolve() on one card of the same deck.

Usage: python3 chip_smoke.py [--four]. Any failed check exits non-zero
without a result line; on success the last stdout line is
{"ok": true, "device": {"platform": ..., "kind": ..., "count": ...}}.
"""

from __future__ import annotations

import argparse
import contextlib
import io
import json
import os
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))

# f32-vs-f64 bounds, each max|f32 - f64| / max|f64| unless noted. The
# reference sees the same inputs: particle positions are drawn as f32 cell
# positions and the f64 reference uses exactly those values.
# - one-hot deposit / gather (cell positions in): a handful of f32
#   products and sums per output, ~1e-7 at full f32 precision; a one-hot
#   product run as TF32 (10-bit mantissa) lands near 1e-3 and fails
KERNEL_RTOL = 1e-5
# - scatter deposit / direct gather (physical positions in): the kernel
#   converts x to a cell position in f32, and at 1023^2 over |x| <= 8 one
#   ulp of x is ~6e-5 of a cell, which moves the shape weights by as much
POSITION_RTOL = 5e-4
# - DST solve: f32 FFT roundoff over two 2D transforms of 1024-point
#   lengths, amplified by the inverse Laplacian's spread of eigenvalues
DST_RTOL = 1e-4
# - multigrid: the f32 solve stops at MG_RTOL_SOLVE residual (relative);
#   its error against the converged f64 solve is bounded by that times the
#   V-cycle's error-to-residual ratio
MG_RTOL_SOLVE = 1e-5
MG_RTOL = 1e-4
# - end-to-end physics: field/beam sums of one full time step
#   (tests/test_f32_physics.py)
F32_BOUND = 1e-3

# XLA's own compile of each program (tracing events nest and are left out)
COMPILE_EVENT = "/jax/core/compile/backend_compile_duration"


class SmokeError(RuntimeError):
    """A failed check."""


def check(cond: bool, what: str) -> None:
    if not cond:
        raise SmokeError(what)


def card_line() -> str:
    """`nvidia-smi --query-gpu=name,power.limit` for every visible card."""
    r = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return "; ".join(ln.strip() for ln in r.stdout.splitlines()
                     if ln.strip())


def result_line(devices) -> str:
    """The contract's last line for the given jax devices."""
    d = devices[0]
    return json.dumps({"ok": True, "device": {
        "platform": d.platform, "kind": d.device_kind,
        "count": len(devices)}})


class CompileClock:
    """Context manager summing XLA backend-compile seconds inside it."""

    def __enter__(self):
        import jax
        self.seconds = 0.0
        jax.monitoring.register_event_duration_secs_listener(self._on_event)
        return self

    def __exit__(self, *exc):
        import jax
        jax.monitoring.unregister_event_duration_listener(self._on_event)

    def _on_event(self, event, duration, **_kw):
        if event == COMPILE_EVENT:
            self.seconds += duration


class _TimedLines(io.TextIOBase):
    """Text sink that keeps (perf_counter, line) for every line and echoes
    to `echo`."""

    def __init__(self, echo):
        self.echo = echo
        self.lines = []
        self._buf = ""

    def write(self, s):
        self.echo.write(s)
        self._buf += s
        while "\n" in self._buf:
            line, self._buf = self._buf.split("\n", 1)
            self.lines.append((time.perf_counter(), line))
        return len(s)

    def flush(self):
        self.echo.flush()


def rel_err(a, ref) -> float:
    import numpy as np
    a = np.asarray(a, np.float64)
    ref = np.asarray(ref, np.float64)
    return float(np.max(np.abs(a - ref)) / max(np.max(np.abs(ref)), 1e-300))


def read_fields(path: str, it: int) -> dict:
    """name -> array of every field dataset of iteration `it` (h5 or json
    openPMD file)."""
    import numpy as np
    out = {}
    if path.endswith(".json"):
        with open(path) as f:
            mesh = json.load(f)["data"][str(it)]["fields"]

        def walk(node, name):
            if "data" in node:
                out[name] = np.asarray(node["data"], np.float64)
                return
            for k, v in node.items():
                walk(v, f"{name}/{k}" if name else k)
        walk(mesh, "")
        return out
    import h5py
    with h5py.File(path, "r") as f:
        def visit(name, obj):
            if isinstance(obj, h5py.Dataset):
                out[name] = np.asarray(obj, np.float64)
        f[f"data/{it}/fields"].visititems(visit)
    return out


# ----------------------------------------------------------------------
def phase_device(card: str):
    import jax

    from hipace_tpu.utils.backend import compilation_cache_dir
    devices = jax.devices()
    d = devices[0]
    check(d.platform == "gpu",
          f"JAX found no GPU (platform {d.platform!r}); this check runs "
          "only on a CUDA card")
    print(f"# device: {d.device_kind}, {len(devices)} visible "
          f"(platform {d.platform})")
    print(card)
    print(f"# compile cache: {compilation_cache_dir()}")
    return devices


def phase_main_path(card: str, out_dir: str, nxy: int = 1023, nz: int = 128,
                    max_step: int = 3):
    """The CLI on the transverse benchmark deck; returns a metrics dict."""
    import jax
    import numpy as np

    import decks
    from hipace_tpu import __main__ as cli
    from hipace_tpu.pipeline import simulation as simmod

    try:
        import h5py  # noqa: F401
        backend = "h5"
    except ImportError:
        backend = "json"
    prefix = os.path.join(out_dir, "main_path")
    npart = max(1024, nxy * nxy * 10 * nz // 1000)
    argv = [decks.path("transverse_benchmark"),
            f"my_constants.nxy={nxy}", f"amr.n_cell={nxy} {nxy} {nz}",
            f"beam.num_particles={npart}", f"max_step={max_step}",
            "hipace.dt=1.", "hipace.verbose=1", "hipace.pipeline=0",
            "diagnostic.output_period=-1", "diagnostic.diag_type=xz",
            "diagnostic.field_data=Ez ExmBy EypBx Bz Psi jz_beam",
            "diagnostic.beam_data=none",
            f"hipace.openpmd_backend={backend}",
            f"hipace.file_prefix={prefix}"]

    sims = []
    orig_evolve = simmod.Simulation.evolve

    def evolve(self, *a, **k):
        sims.append(self)
        return orig_evolve(self, *a, **k)

    out = _TimedLines(sys.stdout)
    err = _TimedLines(sys.stderr)
    simmod.Simulation.evolve = evolve
    try:
        with contextlib.redirect_stdout(out), \
                contextlib.redirect_stderr(err), CompileClock() as clock:
            t0 = time.perf_counter()
            rc = cli.main(argv)
            wall = time.perf_counter() - t0
    finally:
        simmod.Simulation.evolve = orig_evolve
    check(rc == 0, f"main path: CLI returned {rc}")
    check(len(sims) == 1, "main path: expected one serial evolve()")
    sim = sims[0]

    starts = {}
    for t, line in out.lines:
        if line.startswith("Rank 0 started step "):
            starts[int(line.split()[4])] = t
    check(sorted(starts) == list(range(max_step + 1)),
          f"main path: step lines {sorted(starts)}")
    # steps 1..max_step-1 write no output (output_period=-1: last only)
    step_s = (starts[max_step] - starts[1]) / (max_step - 1)
    g = sim.geom
    plasma_pushes = sum(g.nx * g.ny * p.ppc[0] * p.ppc[1]
                        * max(1, p.n_subcycles) for p in sim.plasma_cfgs)
    beam_pushes = sum((b.num_particles or 0) * max(1, b.n_subcycles)
                      for b in sim.beam_cfgs)
    pushes = plasma_pushes * g.nz + beam_pushes
    m = {
        "wall_s": wall, "compile_s": clock.seconds, "step_s": step_s,
        "slices_per_s": g.nz / step_s,
        "ns_per_push": 1e9 * step_s / pushes,
        "ns_per_cell": 1e9 * step_s / (g.nx * g.ny * g.nz),
        # None on the CPU backend (rehearsals)
        "peak_bytes": (jax.devices()[0].memory_stats() or {}).get(
            "peak_bytes_in_use", -1),
        "use_banded": bool(sim.cfg.use_banded),
    }
    tag = (f"[{card}; {g.nx}x{g.ny}x{g.nz}, f32, "
           f"use_banded={int(m['use_banded'])}]")
    print(f"# main path: XLA compile {m['compile_s']:.2f} s (all of the "
          f"run), CLI wall {wall:.2f} s {tag}")
    print(f"# main path: steady step {step_s:.4f} s (mean of steps 1.."
          f"{max_step - 1}) {tag}")
    print(f"# main path: {m['slices_per_s']:.3f} slices/s {tag}")
    print(f"# main path: {m['ns_per_push']:.4f} ns/push {tag}")
    print(f"# main path: {m['ns_per_cell']:.4f} ns/cell {tag}")
    print(f"# main path: peak_bytes_in_use {m['peak_bytes']} {tag}")

    check(not any("contributions dropped" in ln for _, ln in err.lines),
          "main path: banded deposit contributions dropped")
    path = os.path.join(prefix, f"openpmd_{max_step:06d}.{backend}")
    fields = read_fields(path, max_step)
    check(len(fields) >= 5, f"main path: fields written {sorted(fields)}")
    for name, arr in fields.items():
        check(bool(np.all(np.isfinite(arr))),
              f"main path: field {name} has non-finite values")
    ez = fields["Ez"]                                   # xz diag: (nz, nx)
    axis = ez[:, ez.shape[1] // 2]
    zeta = g.prob_lo[2] + (np.arange(g.nz) + 0.5) * g.dz
    behind = np.abs(axis[zeta < -2.0])                  # beam centre at 0
    check(behind.size > 0 and float(behind.max()) > 1e-3
          * float(np.abs(ez).max()) and float(np.abs(ez).max()) > 0,
          "main path: no wake (on-axis Ez behind the driver is zero)")
    return m


def _plasma_cells(nxy: int, seed: int = 0):
    """One particle per cell of an (nxy, nxy) slice with random jitter,
    generated row by row (so row-sorted): f32-exact guard-offset cell
    positions (xm, ym), the physical positions they map to (f64), and 13
    f32-exact value channels."""
    import numpy as np

    from hipace_tpu.geometry import Geometry
    g = Geometry(n_cell=(nxy, nxy, 8), prob_lo=(-8.0, -8.0, -6.0),
                 prob_hi=(8.0, 8.0, 6.0), nguards=3)
    rng = np.random.default_rng(seed)
    iy, ix = np.mgrid[0:nxy, 0:nxy]
    G = g.nguards

    def jitter():
        # offsets within a cell, kept 0.002 cells off the integer and
        # half-integer points where order-0 weights jump: there the f32
        # position rounding of the scatter path could flip a particle's
        # cell against the reference
        n = nxy * nxy
        return rng.uniform(0.002, 0.498, n) + 0.5 * rng.integers(0, 2, n)

    xm = (G + ix.ravel() + jitter()).astype(np.float32)
    ym = (G + iy.ravel() + jitter()).astype(np.float32)
    x = (xm.astype(np.float64) - G) * g.dx + g.x_pos_offset
    y = (ym.astype(np.float64) - G) * g.dy + g.y_pos_offset
    vals = rng.uniform(-1.0, 1.0, (nxy * nxy, 13)).astype(np.float32)
    return g, xm, ym, x, y, vals.astype(np.float64)


def phase_kernels(card: str, nxy: int = 1023, K: int = 8192):
    """f32 kernels (run as in production, x64 off) against their f64
    reference of the same inputs (x64 on), both on the card."""
    import jax
    import jax.numpy as jnp
    import numpy as np

    from hipace_tpu.fields.multigrid import MultiGrid
    from hipace_tpu.fields.poisson import DirichletPoissonSolver
    from hipace_tpu.ops.banded import banded_deposit, banded_gather_main
    from hipace_tpu.ops.deposit import deposit_multi
    from hipace_tpu.ops.gather import gather_main_fields

    f32, f64 = jnp.float32, jnp.float64
    g, xm, ym, x, y, vals = _plasma_cells(nxy)
    NY, NX = g.slice_shape
    N = x.size
    pad = (-N) % K
    xm = np.concatenate([xm, np.full(pad, 2.0 * NX)])
    ym = np.concatenate([ym, np.full(pad, 2.0 * NY)])
    vpad = np.concatenate([vals, np.zeros((pad, 13))])
    print(f"# kernels: {N} particles, {nxy}^2, 13 channels, f32 on the "
          f"card vs f64 on the card [{card}]")

    def on(dt, fn, *args):
        """fn(*args) with numpy args cast to dt, x64 on iff dt is f64;
        results come back as numpy."""
        with jax.enable_x64(dt == f64):
            cast = [jnp.asarray(a, dt) if isinstance(a, np.ndarray) else a
                    for a in args]
            return jax.tree.map(np.asarray, fn(*cast))

    zeros13 = np.zeros((13, NY, NX))
    for order in range(4):
        def scatter(f, xx, yy, v, order=order):
            return deposit_multi(f, xx, yy, [v[:, c] for c in range(13)],
                                 g, order)
        ref = on(f64, jax.jit(scatter), zeros13, x, y, vals)
        e_s = rel_err(on(f32, jax.jit(scatter), zeros13, x, y, vals), ref)
        oh = on(f32, lambda f, yy, xx, v, order=order: banded_deposit(
            f, yy, xx, v, NY, NX, order, W=32, K=K)[0],
            zeros13, ym, xm, vpad)
        e_b = rel_err(oh, ref)
        print(f"# kernels: deposit order {order}: scatter rel {e_s:.3e} "
              f"(bound {POSITION_RTOL:g}), one-hot rel {e_b:.3e} (bound "
              f"{KERNEL_RTOL:g})")
        check(e_s <= POSITION_RTOL and e_b <= KERNEL_RTOL,
              f"deposit order {order}: f32 vs f64 {e_s:.3e} / {e_b:.3e}")

    rng = np.random.default_rng(1)

    def f32_exact(shape, nonneg=False):
        a = rng.standard_normal(shape)
        a = np.abs(a) if nonneg else a
        return a.astype(np.float32).astype(np.float64)

    stack = f32_exact((5, NY, NX))

    def gather(xx, yy, st):
        return gather_main_fields(xx, yy, *st, g, 2)
    ref = on(f64, jax.jit(gather), x, y, stack)
    e_g = max(rel_err(a, r)
              for a, r in zip(on(f32, jax.jit(gather), x, y, stack), ref))
    oh = on(f32, lambda st, yy, xx: banded_gather_main(
        st, yy, xx, NY, NX, 2, W=32, K=K), np.moveaxis(stack, 0, -1), ym, xm)
    scale = (1.0 / g.dx, 1.0 / g.dy, 1.0, 1.0, 1.0, 1.0)
    e_o = max(rel_err(a[:N] * s, r) for a, s, r in zip(oh[:6], scale, ref))
    print(f"# kernels: 6-field gather: direct rel {e_g:.3e} (bound "
          f"{POSITION_RTOL:g}), one-hot rel {e_o:.3e} (bound "
          f"{KERNEL_RTOL:g})")
    check(e_g <= POSITION_RTOL and e_o <= KERNEL_RTOL,
          f"gather: f32 vs f64 {e_g:.3e} / {e_o:.3e}")

    rhs = f32_exact((3, nxy, nxy))

    def dst(variant, dt):
        return jax.jit(DirichletPoissonSolver(nxy, nxy, g.dx, g.dy, dt,
                                              variant=variant).solve)
    with jax.enable_x64(True):
        ref = on(f64, dst("expanded", f64), rhs)
    for variant in ("fast", "expanded"):
        e = rel_err(on(f32, dst(variant, f32), rhs), ref)
        print(f"# kernels: DST solve ({variant}, 3 channels): rel {e:.3e} "
              f"(bound {DST_RTOL:g})")
        check(e <= DST_RTOL, f"DST {variant}: f32 vs f64 {e:.3e}")

    rhs = f32_exact((2, nxy, nxy))
    acf = f32_exact((nxy, nxy), nonneg=True)

    def mg(dt, tol, max_iters):
        solver = MultiGrid(nxy, nxy, g.dx, g.dy, dt)
        return jax.jit(lambda r, a: solver.solve_info(
            jnp.zeros_like(r), r, a, tol_rel=tol, max_iters=max_iters))
    with jax.enable_x64(True):
        ref, it64 = on(f64, mg(f64, 1e-10, 100), rhs, acf)
    got, it32 = on(f32, mg(f32, MG_RTOL_SOLVE, 40), rhs, acf)
    e = rel_err(got, ref)
    print(f"# kernels: multigrid (2 channels): rel {e:.3e} after "
          f"{int(it32)} V-cycles (f64: {int(it64)}) (bound {MG_RTOL:g})")
    check(e <= MG_RTOL and int(it32) < 40,
          f"multigrid: f32 vs f64 {e:.3e}, {int(it32)} V-cycles")


def _sums(res, ncomp_names) -> dict:
    import numpy as np
    diag = np.asarray(res["diag"], np.float64)          # (nz, C, ny, nx)
    out = {n: float(np.abs(diag[:, i]).sum())
           for i, n in enumerate(ncomp_names)}
    b = res["binned"]
    v = np.asarray(b["valid"])
    for k in ("x", "y", "z", "ux", "uy", "uz", "w"):
        out["beam." + k] = float(np.abs(np.asarray(b[k], np.float64)[v])
                                 .sum())
    return out


# field components compared against their field's largest sum
_FAMILY = {k: fam for fam in (("ExmBy", "EypBx", "Ez"), ("Bx", "By", "Bz"),
                              ("jx", "jy"), ("Sx", "Sy"))
           for k in fam}


def phase_physics(card: str, nxy: int = 255, nz: int = 100):
    """Blowout wake, one time step, f32 against f64 on the card. The deck's
    beam is fixed_ppc, so both precisions start from the same particles
    (a randomly drawn beam would differ between f32 and f64 draws)."""
    import jax
    import jax.numpy as jnp

    import decks
    from hipace_tpu.parser import Inputs
    from hipace_tpu.pipeline.simulation import Simulation

    sums = {}
    for dt in (jnp.float64, jnp.float32):
        with jax.enable_x64(dt == jnp.float64):
            sim = Simulation(Inputs.from_file(
                decks.path("blowout_wake/inputs_normalized"),
                overrides=[f"amr.n_cell={nxy} {nxy} {nz}",
                           "diagnostic.output_period=1",
                           "hipace.openpmd_backend=json"]), dtype=dt,
                verbose=0)
            sums[dt] = _sums(sim.run_step(0), sim.cfg.diag_comps)
    s64, s32 = sums[jnp.float64], sums[jnp.float32]
    big = max(abs(v) for v in s64.values())
    worst = (0.0, None)
    for k, v64 in s64.items():
        if abs(v64) < 1e-12 * big:                  # identically-zero field
            continue
        # a component is measured against its field's scale: Bz of an
        # axisymmetric wake sums to ~1% of Bx, and its f32 roundoff, an
        # absolute error at the level of |B|, is no physics drift
        scale = max(abs(s64[f]) for f in _FAMILY.get(k, (k,)))
        rel = abs(s32[k] - v64) / scale
        worst = max(worst, (rel, k))
    print(f"# physics: blowout {nxy}^2 x {nz}, f32 vs f64 on the card: "
          f"worst rel {worst[0]:.3e} ({worst[1]}) (bound {F32_BOUND:g}) "
          f"[{card}]")
    check(worst[0] < F32_BOUND,
          f"physics: f32 drift {worst[0]:.3e} in {worst[1]}")


def phase_four(card: str, n_dev: int = 4, nxy: int = 255, nz: int = 128,
               npart: int = 100000):
    """evolve_pipelined over n_dev cards vs serial evolve on one card."""
    import jax
    import jax.numpy as jnp
    import numpy as np

    import decks
    from hipace_tpu.parallel.pipeline import _STREAM_KEYS
    from hipace_tpu.parser import Inputs
    from hipace_tpu.pipeline.simulation import Simulation

    devices = jax.devices()
    check(len(devices) >= n_dev, f"--four: {len(devices)} devices visible")
    overrides = [f"amr.n_cell={nxy} {nxy} {nz}",
                 f"beam.num_particles={npart}", f"max_step={n_dev - 1}",
                 "diagnostic.output_period=0", "hipace.verbose=0",
                 "hipace.openpmd_backend=json"]
    runs = {}
    for name in ("serial", "pipelined"):
        sim = Simulation(Inputs.from_file(
            decks.path("get_started/inputs_normalized"),
            overrides=overrides), dtype=jnp.float32, verbose=0)
        with CompileClock() as clock:
            t0 = time.perf_counter()
            if name == "serial":
                sim.evolve(write_output=False)
            else:
                sim.evolve_pipelined(devices=devices[:n_dev],
                                     write_output=False)
            b = sim.binned
            jax.block_until_ready(b["x"])
            wall = time.perf_counter() - t0
        v = np.asarray(b["valid"])
        runs[name] = {k: float(np.abs(np.asarray(b[k], np.float64)[v])
                               .sum())
                      for k in ("x", "y", "z", "ux", "uy", "uz", "w")}
        runs[name]["n"] = float(v.sum())
        cap = b["x"].shape[-1]
        print(f"# four: {name}: wall {wall:.2f} s incl. XLA compile "
              f"{clock.seconds:.2f} s [{card}]")
    nbytes = sum(jnp.dtype(sim.binned[k].dtype).itemsize
                 for k in _STREAM_KEYS)
    print(f"# four: beam bytes streamed per time step per card: "
          f"{nz * cap * nbytes} ({nz} slices x {cap} lanes x {nbytes} B)")
    worst = max((abs(runs["pipelined"][k] - v) / max(abs(v), 1e-300), k)
                for k, v in runs["serial"].items())
    print(f"# four: pipelined vs serial beam sums: worst rel "
          f"{worst[0]:.3e} ({worst[1]}) (bound {F32_BOUND:g})")
    check(worst[0] < F32_BOUND,
          f"--four: pipelined vs serial {worst[0]:.3e} in {worst[1]}")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--four", action="store_true",
                    help="run only the four-card pipelined phase")
    args = ap.parse_args(argv)
    if not (os.path.isdir(os.path.join(HERE, "hipace_tpu"))
            and os.path.isdir(os.path.join(HERE, "decks"))):
        print("chip_smoke: hipace_tpu/ and decks/ not found beside this "
              "script; run it from a checkout of the repository",
              file=sys.stderr)
        return 2
    sys.path.insert(0, HERE)
    out_dir = os.path.join(HERE, "chiprun_out", "chip_smoke")
    os.makedirs(out_dir, exist_ok=True)
    try:
        import jax
        if jax.devices()[0].platform != "gpu":
            raise SmokeError(f"JAX found no GPU (platform "
                             f"{jax.devices()[0].platform!r})")
        card = card_line()
        devices = phase_device(card)
        if args.four:
            phase_four(card)
        else:
            phase_main_path(card, out_dir)
            phase_kernels(card)
            phase_physics(card)
    except (SmokeError, subprocess.SubprocessError, OSError) as e:
        print(f"chip_smoke: FAILED: {e}", file=sys.stderr)
        return 1
    print(result_line(devices))
    return 0


if __name__ == "__main__":
    sys.exit(main())
