"""Measure per-case checksum deviation vs the reference's committed JSONs.

For each case in tests/test_checksums.CASES, run the deck and print the
maximum relative deviation over all compared sums (fields + particles,
honoring the case's skips and the noise floors). Used to pin each case's
rtol at its measured headroom (VERDICT r2 item 6; the reference CI uses
5e-6 for production decks, tests/production.SI.2Rank.sh:25-29).

Usage (HIPACE_REFERENCE_DIR = a HiPACE++ checkout):
    python tools/measure_checksum_headroom.py [case-substring ...]
Prints one JSON line per case: {"case": ..., "max_rel": ..., "argmax": ...}
"""

import json
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))
sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "tests"))

# match the test environment (tests/conftest.py): CPU backend with x64 —
# the headroom is only meaningful at the precision the tests run at
os.environ.setdefault("JAX_PLATFORMS", "cpu")
import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)

import numpy as np


def measure(case, tmpdir):
    import h5py
    from hipace_tpu.parser import Inputs
    from hipace_tpu.pipeline.simulation import Simulation
    from test_checksums import BENCH, BEAM_MAP, ABS_NOISE, REF, _find_field

    name, deck, overrides, rtol, skip_fields, skip_particles = case
    bench = json.load(open(f"{BENCH}/{name}.json"))
    prefix = os.path.join(tmpdir, name.replace("/", "_"))
    inputs = Inputs.from_file(os.path.join(REF, "examples", deck),
                              overrides=list(overrides)
                              + [f"hipace.file_prefix={prefix}"])
    sim = Simulation(inputs, verbose=0)
    sim.evolve()

    it = sim.max_step
    worst = (0.0, None)
    with h5py.File(os.path.join(prefix, f"openpmd_{it:06d}.h5")) as f:
        mesh = f[f"data/{it}/fields"]
        fmax = max(abs(v) for v in bench["lev=0"].values()) or 1.0
        fabs = max(ABS_NOISE, 1e-8 * fmax)
        for field, ref in bench["lev=0"].items():
            if field in skip_fields:
                continue
            ds = _find_field(mesh, field)
            if ds is None:
                worst = (float("inf"), f"{field} MISSING")
                continue
            ours = float(np.sum(np.abs(np.array(ds))))
            # required rtol = the smallest r passing pytest.approx(ref,
            # rel=r, abs=fabs): deviations inside the abs floor need r=0
            d = abs(ours - ref)
            if d <= fabs:
                continue
            rel = d / max(abs(ref), 1e-300)
            if rel > worst[0]:
                worst = (rel, field)
        if skip_particles is not True:
            askip = skip_particles if isinstance(skip_particles, tuple) \
                else ()
            for species, attrs in bench.items():
                if species.startswith("lev="):
                    continue
                gp = f[f"data/{it}/particles/{species}"]
                pmax = max(abs(v) for a, v in attrs.items()
                           if a in BEAM_MAP) or 1.0
                pabs = max(1e-8, 1e-8 * pmax)
                for attr, ref in attrs.items():
                    if attr not in BEAM_MAP or attr in askip:
                        continue
                    ours = float(np.sum(np.abs(
                        np.array(gp[BEAM_MAP[attr]]))))
                    d = abs(ours - ref)
                    if d <= pabs:
                        continue
                    rel = d / max(abs(ref), 1e-300)
                    if rel > worst[0]:
                        worst = (rel, f"{species}.{attr}")
    return worst


def main():
    import tempfile
    from test_checksums import CASES
    pats = sys.argv[1:]
    for case in CASES:
        if pats and not any(p in case[0] for p in pats):
            continue
        with tempfile.TemporaryDirectory() as td:
            try:
                rel, arg = measure(case, td)
                print(json.dumps({"case": case[0], "max_rel": rel,
                                  "argmax": arg,
                                  "current_rtol": case[3]}), flush=True)
            except Exception as e:  # keep sweeping
                print(json.dumps({"case": case[0],
                                  "error": f"{type(e).__name__}: {e}"}),
                      flush=True)


if __name__ == "__main__":
    main()
