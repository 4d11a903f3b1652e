"""Diagnostic: run one checksum CASE from tests/test_checksums.py and dump
every field/particle sum next to the reference benchmark value, with
ratios — no assertions. Usage:

    HIPACE_REFERENCE_DIR=<HiPACE++ checkout> JAX_PLATFORMS=cpu \
        python tools/checksum_diag.py <case-name> [workdir]
"""

import json
import os
import sys

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))
sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "tests"))

import jax

# x64 on the CPU, like tests/conftest.py
jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)

from test_checksums import BEAM_MAP, BENCH, CASES, REF, _find_field  # noqa: E402

from hipace_tpu.parser import Inputs  # noqa: E402
from hipace_tpu.pipeline.simulation import Simulation  # noqa: E402


def main():
    name = sys.argv[1]
    work = sys.argv[2] if len(sys.argv) > 2 else f"ckdiag_{name}"
    case = next(c for c in CASES if c[0] == name)
    _, deck, overrides, rtol, skip_fields, skip_particles = case
    bench = json.load(open(f"{BENCH}/{name}.json"))
    prefix = os.path.join(work, name.replace("/", "_"))
    inputs = Inputs.from_file(os.path.join(REF, "examples", deck),
                              overrides=list(overrides)
                              + [f"hipace.file_prefix={prefix}"])
    sim = Simulation(inputs, verbose=0)
    sim.evolve()

    import h5py
    it = sim.max_step
    with h5py.File(os.path.join(prefix, f"openpmd_{it:06d}.h5")) as f:
        mesh = f[f"data/{it}/fields"]
        print(f"== {name} fields (rtol target {rtol}) ==")
        for field, ref in bench["lev=0"].items():
            ds = _find_field(mesh, field)
            if ds is None:
                print(f"  {field:12s} MISSING (ref {ref:.6e})")
                continue
            ours = float(np.sum(np.abs(np.array(ds))))
            ratio = ours / ref if ref else float("inf")
            flag = "" if abs(ratio - 1) < rtol else "  <-- FAIL"
            skip = " (skipped)" if field in skip_fields else ""
            print(f"  {field:12s} ours {ours: .9e}  ref {ref: .9e}  "
                  f"ratio {ratio:.6f}{flag}{skip}")
        for species, attrs in bench.items():
            if species.startswith("lev="):
                continue
            print(f"== {name} particles/{species}"
                  f"{' (skipped)' if skip_particles else ''} ==")
            gp = f[f"data/{it}/particles/{species}"]
            for attr, ref in attrs.items():
                if attr not in BEAM_MAP:
                    continue
                ours = float(np.sum(np.abs(np.array(gp[BEAM_MAP[attr]]))))
                ratio = ours / ref if ref else float("inf")
                flag = "" if abs(ratio - 1) < rtol else "  <-- FAIL"
                print(f"  {attr:6s} ours {ours: .9e}  ref {ref: .9e}  "
                      f"ratio {ratio:.6f}{flag}")


if __name__ == "__main__":
    main()
