"""Production pipelined driver: 2-device run writes the same openPMD
output as serial.

Mirrors the reference's 2Rank production test shape (ref
/root/reference/tests/production.SI.2Rank.sh and the serial-vs-parallel
equivalence checks in examples/beam_in_vacuum/analysis_2ranks.py): the
full CLI-level surface — per-step openPMD field + beam dumps and in-situ
reduced diagnostics — must be identical whether the steps run serially on
one device or pipelined across the mesh.
"""

import glob
import os
import sys

import h5py
import jax
import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "tools"))

import decks
from hipace_tpu.parser import Inputs
from hipace_tpu.pipeline.simulation import Simulation

OVR = [
    "max_step=3", "amr.n_cell=16 16 32", "beam.num_particles=2000",
    "diagnostic.output_period=2",
]


def _run(tmp_path, tag, pipelined, n_dev):
    prefix = str(tmp_path / tag)
    inputs = Inputs.from_file(
        decks.path("get_started/inputs_normalized"),
        overrides=OVR + [f"hipace.file_prefix={prefix}",
                         "beams.insitu_period=1",
                         f"beam.insitu_file_prefix={prefix}_insitu"])
    sim = Simulation(inputs, verbose=0)
    if pipelined:
        sim.evolve_pipelined(devices=jax.devices()[:n_dev])
    else:
        sim.evolve()
    return prefix


def test_production_2dev_matches_serial(tmp_path):
    assert len(jax.devices()) >= 2, "needs the virtual CPU mesh"
    ser = _run(tmp_path, "serial", False, 1)
    par = _run(tmp_path, "pipe", True, 2)

    ser_files = sorted(glob.glob(os.path.join(ser, "openpmd_*.h5")))
    par_files = sorted(glob.glob(os.path.join(par, "openpmd_*.h5")))
    assert [os.path.basename(f) for f in ser_files] == \
        [os.path.basename(f) for f in par_files]
    assert len(ser_files) == 3  # steps 0, 2, 3(last)

    for fs, fp in zip(ser_files, par_files):
        with h5py.File(fs) as a, h5py.File(fp) as b:
            it = os.path.basename(fs)[8:-3].lstrip("0") or "0"
            ma, mb = a[f"data/{it}/fields"], b[f"data/{it}/fields"]
            for field in ma:
                va, vb = np.array(ma[field]), np.array(mb[field])
                assert np.allclose(va, vb, rtol=1e-9, atol=1e-12), \
                    f"{os.path.basename(fs)}: field {field} differs " \
                    f"(max |d| {np.abs(va - vb).max()})"
            pa = a[f"data/{it}/particles/beam"]
            pb = b[f"data/{it}/particles/beam"]
            for attr in ("position/z", "momentum/z", "weighting"):
                va = np.sort(np.array(pa[attr]))
                vb = np.sort(np.array(pb[attr]))
                assert va.shape == vb.shape
                assert np.allclose(va, vb, rtol=1e-9, atol=1e-12), \
                    f"{os.path.basename(fs)}: beam {attr} differs"

    # in-situ reduced diagnostics match record-for-record
    import read_insitu_diagnostics as diag
    da = diag.read_file(ser + "_insitu/reduced_beam.*.txt")
    db = diag.read_file(par + "_insitu/reduced_beam.*.txt")
    assert list(da["step"]) == list(db["step"]) == [0, 1, 2, 3]
    np.testing.assert_allclose(da["total"]["sum(w)"], db["total"]["sum(w)"],
                               rtol=1e-9)
    np.testing.assert_allclose(diag.gamma_mean(da["average"]),
                               diag.gamma_mean(db["average"]), rtol=1e-9)


def test_production_tail_serial_fallback(tmp_path):
    """Window does not divide max_step+1: the tail must run serially and
    still write every output file."""
    assert len(jax.devices()) >= 2
    prefix = str(tmp_path / "tail")
    inputs = Inputs.from_file(
        decks.path("get_started/inputs_normalized"),
        overrides=["max_step=2", "amr.n_cell=16 16 32",
                   "beam.num_particles=1000", "diagnostic.output_period=1",
                   f"hipace.file_prefix={prefix}"])
    sim = Simulation(inputs, verbose=0)
    sim.evolve_pipelined(devices=jax.devices()[:2])
    files = sorted(glob.glob(os.path.join(prefix, "openpmd_*.h5")))
    assert len(files) == 3
