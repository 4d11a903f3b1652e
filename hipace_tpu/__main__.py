"""CLI entry point: ``python -m hipace_tpu inputs_file [key=value ...]``.

Mirrors the reference executable's interface (ref: /root/reference/src/
main.cpp:15-25): an inputs deck plus command-line overrides, running
InitData + Evolve and writing openPMD output.
"""

from __future__ import annotations

import sys
import time


def main(argv=None):
    argv = sys.argv[1:] if argv is None else argv
    if not argv:
        print("usage: python -m hipace_tpu <inputs_file> [key=value ...]")
        return 1
    import jax

    from .parser import Inputs
    from .pipeline.simulation import Simulation

    inputs = Inputs.from_file(argv[0], overrides=argv[1:])
    # double precision on the CPU for physics fidelity, f32 on
    # accelerators for speed
    platform = jax.devices()[0].platform
    if platform == "cpu":
        jax.config.update("jax_enable_x64", True)

    # profiling (the reference's HIPACE_PROFILE/TinyProfiler region tracing,
    # ref utils/HipaceProfilerWrapper.H): hipace.profile = <trace dir>
    # writes a jax profiler trace viewable in TensorBoard/Perfetto
    trace_dir = inputs.query("hipace.profile", "", str)

    # multi-device temporal pipeline (the reference's mpiexec -n N mode,
    # ref Hipace.cpp:400-401): device d runs steps d, d+N, ... with beam
    # and laser slices streamed around the device ring. hipace.pipeline=0
    # forces serial even with multiple devices.
    n_dev = len(jax.devices())
    use_pipeline = inputs.query("hipace.pipeline", True, bool) and n_dev > 1

    t0 = time.perf_counter()
    sim = Simulation(inputs)

    def run():
        if use_pipeline:
            sim.evolve_pipelined()
        else:
            sim.evolve()

    if trace_dir:
        with jax.profiler.trace(trace_dir):
            run()
    else:
        run()
    wall = time.perf_counter() - t0

    nz = sim.geom.nz
    n_steps = sim.max_step + 1
    n_ranks = n_dev if use_pipeline else 1
    print(f"Finished Evolve after {wall:.6g} seconds using {n_ranks} rank"
          + ("s" if n_ranks > 1 else ""))
    n_plasma = sum(int(p.ppc[0] * p.ppc[1]) * max(1, p.n_subcycles)
                   for p in sim.plasma_cfgs) * sim.geom.nx * sim.geom.ny
    pushes = (n_plasma * nz
              + sum((b.num_particles or 0) * max(1, b.n_subcycles)
                    for b in sim.beam_cfgs)) * n_steps
    if pushes:
        print(f"Total time per particle push: {1e9 * wall / pushes:.4g} "
              "nanoseconds")
    cells = sim.geom.nx * sim.geom.ny * nz * n_steps
    print(f"Total time per cell update: {1e9 * wall / cells:.4g} nanoseconds")
    return 0


if __name__ == "__main__":
    sys.exit(main())
