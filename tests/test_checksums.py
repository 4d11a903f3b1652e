"""Reference checksum regression: reproduce HiPACE++'s committed CI numbers.

The reference's physics-fidelity acceptance criterion (SURVEY.md §4) is its
checksum suite: run a deck, compute sum(|Q|) per field / per beam attribute
(ref /root/reference/tests/checksum/checksum.py:44-80 with the openPMD
backend's sum reduction), compare against the committed JSON
(tests/checksum/benchmarks_json). Here we run the SAME reference decks
through hipace_tpu and compare against the reference's OWN benchmark files.

Case list mirrors the reference's tests/*.sh command lines (overrides,
skips, output iteration). Multi-rank (2Rank) cases run serially here —
the reference's own analysis_2ranks.py asserts serial==parallel, and our
pipeline equivalence suite (test_pipeline_parallel.py) pins that property
independently.

Our fp64 CPU runs agree with the reference's committed numbers to a few
1e-4 relative for deterministic decks (different FFT/transcendental
stack); decks with randomly drawn beams agree statistically (~N^-1/2).
"""

import json
import os

import numpy as np
import pytest

from hipace_tpu.parser import Inputs
from hipace_tpu.pipeline.simulation import Simulation

# a HiPACE++ source checkout: its committed checksum JSONs are the expected
# values (they cannot be rebuilt here) and they belong to its own
# examples/ decks, so both come from there; without it every case skips
REF = os.environ.get("HIPACE_REFERENCE_DIR", "")
BENCH = os.path.join(REF, "tests", "checksum", "benchmarks_json")

BEAM_MAP = {"x": "position/x", "y": "position/y", "z": "position/z",
            "ux": "momentum/x", "uy": "momentum/y", "uz": "momentum/z",
            "w": "weighting"}

SXSYCHI = ("Sy", "Sx", "chi")

# sums whose reference value is below this are near-zero noise (identically
# zero fields summed over roundoff); compared with abs tolerance instead
ABS_NOISE = 1e-5

CASES = [
    # (benchmark json name, deck, overrides, rtol, skip_fields,
    #  skip_particles)
    #
    # rtol pinning: each deterministic case's rtol is ~3x the max_rel
    # deviation measured in THIS environment (CPU x64, 2026-08, v r5;
    # tools/measure_checksum_headroom.py — table in PARITY.md). Cases
    # measured at max_rel=0 (every deviation under the abs noise floors)
    # pin at 1e-5, twice the reference CI's own production tolerance
    # (ref tests/production.SI.2Rank.sh:25-29 uses 5e-6). Cross-RNG
    # cases (different random stream than the reference) keep
    # statistical tolerances, noted per case.
    ("blowout_wake.Serial",
     "blowout_wake/inputs_normalized",
     [], 1.5e-3, (), False),  # measured 4.8e-4 (Bz)
    ("linear_wake.normalized.1Rank",
     "linear_wake/inputs_normalized",
     ["diagnostic.field_data=all rho"], 1e-5, (), False),  # measured 0
    ("beam_in_vacuum.normalized.Serial",
     "beam_in_vacuum/inputs_normalized",
     ["hipace.depos_order_xy=0", "diagnostic.field_data=all rho"],
     5e-3, (), False),  # measured 1.6e-3 (By)
    # --- round 2 additions (ref tests/*.sh command lines) ---
    ("blowout_wake_explicit.2Rank",
     "blowout_wake/inputs_normalized",
     ["max_step=1"], 5e-4, SXSYCHI, False),  # measured 1.4e-4 (Ez)
    ("linear_wake.SI.1Rank",
     "linear_wake/inputs_SI",
     ["diagnostic.field_data=all rho"], 3e-5, (), False),  # meas 7.3e-6
    ("beam_in_vacuum.SI.Serial",
     "beam_in_vacuum/inputs_SI",
     ["hipace.depos_order_xy=0", "diagnostic.field_data=all rho"],
     1e-5, (), False),  # measured 0
    ("ion_motion.SI.1Rank",
     "linear_wake/inputs_ion_motion_SI",
     ["hipace.bxby_solver=explicit"], 1e-3, SXSYCHI,
     False),  # measured 3.4e-4 (Ez)
    # random beam + fields summing to ~1e-6 (the reference itself uses
    # rtol=1 on CUDA here, tests/radiation_reaction.1Rank.sh:14): sums
    # below ABS_NOISE are treated as noise-level
    ("radiation_reaction.1Rank",
     "beam_in_vacuum/inputs_RR",
     [], 1.5e-2, (), False),  # cross-RNG; measured 5.0e-3 (beam.ux)
    ("grid_current.1Rank",
     "beam_in_vacuum/inputs_normalized",
     ["amr.n_cell=32 32 32", "max_step=1", "hipace.depos_order_xy=0",
      "geometry.prob_lo=-8. -8. -6.", "geometry.prob_hi=8. 8. 6.",
      "grid_current.use_grid_current=1",
      "grid_current.peak_current_density=0.2",
      "grid_current.position_mean=0. 0. 0.",
      "grid_current.position_std=0.3 0.3 1.41",
      "diagnostic.output_period=1", "beam.profile=gaussian",
      "beam.position_std=0.3 0.3 1.41", "beam.density=0.2",
      "beam.radius=1.", "beam.ppc=1 1 1"],
     1e-5, (), False),  # measured 0
    ("beam_in_vacuum_open_boundary.normalized.1Rank",
     "beam_in_vacuum/inputs_normalized",
     ["hipace.depos_order_xy=0", "hipace.bxby_solver=predictor-corrector",
      "hipace.predcorr_B_mixing_factor=0.95",
      "hipace.predcorr_max_iterations=5",
      "boundary.field=Open", "boundary.particle=Absorbing",
      "geometry.prob_lo=-4. -4. -2.", "geometry.prob_hi=4. 4. 2.",
      "beam.position_mean=2. -1. 0.", "diagnostic.field_data=all rho"],
     1e-5, (), False),  # measured 0
    ("laser_blowout_wake_explicit.1Rank",
     "blowout_wake/inputs_normalized",
     ["max_step=0", "beams.names=no_beam",
      "geometry.prob_lo=-20. -20. -7.5", "geometry.prob_hi=20. 20. 6",
      "lasers.names=laser", "lasers.lambda0=.8e-6", "laser.a0=4.5",
      "laser.position_mean=0. 0. 0", "laser.w0=4", "laser.L0=2",
      "amr.n_cell=128 128 100"],
     3e-5, SXSYCHI, True),  # measured 9.8e-6 (Bx)
    ("laser_blowout_wake_explicit.SI.1Rank",
     "blowout_wake/inputs_SI",
     ["max_step=0", "beams.names=no_beam",
      "geometry.prob_lo=-20.*kp_inv -20.*kp_inv -7.5*kp_inv",
      "geometry.prob_hi=20.*kp_inv 20.*kp_inv 6.*kp_inv",
      "lasers.names=laser", "lasers.lambda0=.8e-6", "laser.a0=4.5",
      "laser.position_mean=0. 0. 0", "laser.w0=4.*kp_inv",
      "laser.L0=2.*kp_inv", "amr.n_cell=128 128 100"],
     2e-5, SXSYCHI, True),  # measured 3.7e-6 (Ez)
    # ionization draws use a different RNG stream than the reference;
    # the ionized population (and the fields it sources) agrees only
    # statistically (~1% at this deck's count)
    ("ionization.2Rank",
     "blowout_wake/inputs_ionization_SI",
     ["hipace.dt=1e-12", "diagnostic.output_period=2", "max_step=2"],
     5e-2, (), False),  # cross-RNG; measured 3.4e-2 (jy_beam)
    ("gaussian_linear_wake.normalized.1Rank",
     "linear_wake/inputs_normalized",
     ["beam.profile=gaussian", "beam.zmin=-5.9", "beam.zmax=5.9",
      "beam.radius=10", "beam.position_mean=0. 0. 0",
      "beam.position_std=2 2 1.41", "geometry.prob_lo=-10. -10. -6",
      "geometry.prob_hi=10. 10. 6", "diagnostic.field_data=all rho"],
     1e-5, (), False),  # measured 0
    ("gaussian_linear_wake.SI.1Rank",
     "linear_wake/inputs_SI",
     ["beam.profile=gaussian", "beam.zmin=-59.e-6", "beam.zmax=59.e-6",
      "beam.radius=100.e-6", "beam.position_mean=0. 0. 0",
      "beam.position_std=20.e-6 20.e-6 14.1e-6",
      "geometry.prob_lo=-100.e-6 -100.e-6 -60.e-6",
      "geometry.prob_hi=100.e-6 100.e-6 60.e-6",
      "diagnostic.field_data=all rho"],
     3e-5, (), False),  # measured 7.3e-6 (Ez)
    # the script's checksum evaluates its LAST run: the SI deck with no
    # overrides (the tilted-beam runs only feed analysis.py). 100k random
    # draws from a different RNG stream: statistical rtol (ref uses .01)
    ("gaussian_weight.1Rank",
     "gaussian_weight/inputs_SI",
     [], 2e-2, (), False),  # cross-RNG; measured 1.0e-2 (Sy)
    ("adaptive_time_step.1Rank",
     "beam_in_vacuum/inputs_normalized",
     ["amr.n_cell=32 32 32", "max_step=20",
      "geometry.prob_lo=-2. -2. -2.", "geometry.prob_hi=2. 2. 2.",
      "diagnostic.output_period=20", "beam.density=1", "beam.radius=1.",
      "beam.n_subcycles=4", "beam.ppc=4 4 1",
      "beams.external_E(x,y,z,t)=0. 0. .5*z", "hipace.dt=adaptive",
      "plasmas.adaptive_density=1",
      "hipace.nt_per_betatron=89.7597901025655"],
     2e-6, (), False),  # measured 4.7e-7 (beam.uz)
    ("beam_evolution.1Rank",
     "beam_in_vacuum/inputs_normalized",
     ["amr.n_cell=32 32 10", "max_step=20",
      "geometry.prob_lo=-2. -2. -2.", "geometry.prob_hi=2. 2. 2.",
      "hipace.dt=3.", "diagnostic.output_period=20",
      "beam.density=1.e-8", "beam.radius=1.", "beam.ppc=4 4 1",
      "beams.external_E(x,y,z,t)=.5*x .5*y 0."],
     1e-5, (), False),  # measured 0
    ("reset.2Rank",
     "blowout_wake/inputs_normalized",
     ["max_step=2", "hipace.MG_tolerance_rel=1e-5"],
     5e-5, (), False),  # measured 1.4e-5 (Ez)
    # collisions draw from a different RNG stream than the reference,
    # but at these decks' densities the collisional kick barely moves
    # the sums: measured deviations are deterministic-level, pinned
    # with extra slack for benign draw-order changes
    ("collisions.SI.1Rank",
     "blowout_wake/inputs_SI",
     ["hipace.collisions=collision1", "collision1.species=plasma plasma"],
     1e-3, (), False),  # measured 2.5e-4 (Sx)
    ("collisions_beam.SI.1Rank",
     "blowout_wake/inputs_SI",
     ["hipace.collisions=collision1", "collision1.species=beam plasma"],
     1e-3, (), False),  # measured 1.4e-4 (Ez)
    # same command line as blowout_wake_explicit.2Rank (the reference's
    # two JSONs are byte-identical); the script's second leg also runs
    # plasmas.reorder_period=4, exercised here via the sort-period map
    ("blowout_wake.2Rank",
     "blowout_wake/inputs_normalized",
     ["max_step=1", "plasmas.reorder_period=4", "hipace.use_banded=1"],
     5e-4, SXSYCHI, False),  # measured 1.4e-4 (Ez)
    # 1M-draw fixed_weight beam from a different RNG stream: statistical
    # agreement (~N^-1/2) only
    ("hosing.2Rank",
     "blowout_wake/inputs_normalized",
     ["hipace.dt=20", "diagnostic.output_period=10", "max_step=10",
      "beam.injection_type=fixed_weight", "beam.num_particles=1000000",
      "beam.density=200", "beam.position_std=0.1 0.1 1.41",
      'beam.position_mean="(z-0)*0.2" "0." "0."',
      "plasmas.names=plasma ions",
      "plasma.neutralize_background=0", "ions.density(x,y,z)=1.",
      "ions.ppc=1 1", "ions.charge=1", "ions.mass=1836",
      "ions.neutralize_background=0"],
     # jz/rho appear in the (stale) benchmark JSON but the modern explicit
     # solver does not allocate them (ref Fields.cpp:118-137). The hosing
     # instability amplifies the RNG-stream difference exponentially over
     # the 10 big steps, so instability-amplitude sums (transverse beam
     # momenta/currents) are skipped and fields compare at 10% — the tilt
     # growth (sum|x|) itself is pinned at that tolerance, which a run
     # without the instability fails by ~16x
     1e-1, SXSYCHI + ("jz", "rho", "jx_beam", "jy_beam", "Bz"),
     ("ux", "uy")),  # cross-RNG + instability; measured 7.0e-2 (Ez)
    ("laser_evolution.SI.2Rank",
     "laser/inputs_SI",
     ["lasers.solver_type=fft"], 1e-5, (), True),  # measured 0
    ("beam_in_vacuum.normalized.1Rank",
     "beam_in_vacuum/inputs_normalized",
     ["hipace.depos_order_xy=0", "diagnostic.field_data=all rho",
      "hipace.MG_tolerance_rel=1e-5"],
     6e-4, (), False),  # measured 1.9e-4 (By)
    ("beam_in_vacuum.SI.1Rank",
     "beam_in_vacuum/inputs_SI",
     ["hipace.depos_order_xy=0", "diagnostic.field_data=all rho",
      "hipace.MG_tolerance_rel=1e-5"],
     1e-5, (), False),  # measured 0
    # the full 1023^2 x 1000-slice bench deck: heavy on CPU (~10 min),
    # run with -k transverse explicitly or as part of the full suite
    ("transverse_benchmark.1Rank",
     "benchmarks/inputs_transverse_benchmark",
     ["diagnostic.output_period=1", "my_constants.nxy=1023"],
     5e-3, SXSYCHI, False),
    # reset.1Rank: stale old-format benchmark JSON with no test script in
    # the reference CI — not mirrored (reset.2Rank covers the deck)
    ("production.SI.2Rank_pwfa",
     "get_started/inputs_pwfa",
     ["max_step=10", "amr.n_cell=64 64 100"],
     5e-3, (), False),
    ("production.SI.2Rank_lwfa",
     "get_started/inputs_lwfa",
     ["max_step=10", "amr.n_cell=64 64 100"],
     5e-3, (), True),
]


def _find_field(mesh, field):
    """Resolve a field dataset: directly in the fields group, or inside a
    named-diagnostic subgroup (our writer nests e.g. laser_diag/)."""
    if field in mesh:
        return mesh[field]
    for key in mesh:
        sub = mesh[key]
        if hasattr(sub, "keys") and field in sub:
            return sub[field]
    return None


# multi-minute cases, deselectable with -m 'not heavy' (the CI fast lane)
HEAVY = {"transverse_benchmark.1Rank", "hosing.2Rank",
         "production.SI.2Rank_pwfa", "production.SI.2Rank_lwfa"}
PARAMS = [pytest.param(*c, marks=pytest.mark.heavy) if c[0] in HEAVY else c
          for c in CASES]


@pytest.mark.parametrize(
    "name,deck,overrides,rtol,skip_fields,skip_particles",
    PARAMS, ids=[c[0] for c in CASES])
def test_reference_checksum(name, deck, overrides, rtol, skip_fields,
                            skip_particles, tmp_path):
    import h5py
    bench_json = os.path.join(BENCH, f"{name}.json")
    if not REF or not os.path.isfile(bench_json):
        pytest.skip(f"reference checksum {name}.json not available (set "
                    "HIPACE_REFERENCE_DIR to a HiPACE++ checkout)")
    with open(bench_json) as f:
        bench = json.load(f)
    prefix = str(tmp_path / name.replace("/", "_"))
    inputs = Inputs.from_file(os.path.join(REF, "examples", deck),
                              overrides=list(overrides)
                              + [f"hipace.file_prefix={prefix}"])
    sim = Simulation(inputs, verbose=0)
    sim.evolve()

    it = sim.max_step
    with h5py.File(os.path.join(prefix, f"openpmd_{it:06d}.h5")) as f:
        mesh = f[f"data/{it}/fields"]
        # scale-aware noise floor: sums that are ~1e-8 of the block's
        # largest sum are roundoff asymmetry (e.g. the reference's
        # sum|ux| = 0.52 for a symmetric beam with sum|uz| = 1e8)
        fmax = max(abs(v) for v in bench["lev=0"].values()) or 1.0
        fabs = max(ABS_NOISE, 1e-8 * fmax)
        for field, ref in bench["lev=0"].items():
            if field in skip_fields:
                continue
            ds = _find_field(mesh, field)
            assert ds is not None, f"{name}: field {field} not written"
            ours = float(np.sum(np.abs(np.array(ds))))
            assert ours == pytest.approx(ref, rel=rtol, abs=fabs), \
                f"{name}: {field} checksum {ours} vs reference {ref}"
        if skip_particles is True:
            return
        askip = skip_particles if isinstance(skip_particles, tuple) else ()
        for species, attrs in bench.items():
            if species.startswith("lev="):
                continue
            gp = f[f"data/{it}/particles/{species}"]
            pmax = max(abs(v) for a, v in attrs.items()
                       if a in BEAM_MAP) or 1.0
            pabs = max(1e-8, 1e-8 * pmax)
            for attr, ref in attrs.items():
                if attr not in BEAM_MAP or attr in askip:
                    continue  # bookkeeping / per-case skipped attributes
                ours = float(np.sum(np.abs(np.array(gp[BEAM_MAP[attr]]))))
                assert ours == pytest.approx(ref, rel=rtol, abs=pabs), \
                    f"{name}: {species}.{attr} {ours} vs reference {ref}"
