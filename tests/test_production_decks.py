"""The reference's get_started production decks run unchanged (shrunk).

Mirrors tests/production.SI.2Rank.sh: the PWFA deck (SI units, two beams,
electron + H ion plasma, adaptive dt, xz diag) and the LWFA deck (laser
driver, multigrid envelope solver, parsed multi-line density with if(),
my_constants chains with predefined physics constants).
"""

import numpy as np
import pytest

import decks
from hipace_tpu.parser import Inputs
from hipace_tpu.pipeline.simulation import Simulation

PWFA = decks.path("get_started/inputs_pwfa")
LWFA = decks.path("get_started/inputs_lwfa")


def test_pwfa_deck(tmp_path):
    inputs = Inputs.from_file(PWFA, overrides=[
        "max_step=1", "amr.n_cell=32 32 48",
        "driver.num_particles=4000", "witness.num_particles=2000",
        f"hipace.file_prefix={tmp_path}/pwfa",
        "diagnostic.output_period=1"])
    sim = Simulation(inputs, verbose=0)
    assert sim.dt > 0  # hipace.dt = adaptive resolved from beam energy
    sim.evolve()
    import h5py
    with h5py.File(f"{tmp_path}/pwfa/openpmd_000001.h5", "r") as f:
        ez = np.asarray(f["data/1/fields/Ez"])     # xz diag -> (nz, nx)
    assert ez.ndim == 2
    assert np.all(np.isfinite(ez))
    assert np.abs(ez).max() > 0


def test_max_time(tmp_path):
    """hipace.max_time clamps dt to land exactly on the final time and runs
    one dt=0 step there (ref Hipace.cpp:424-435)."""
    inputs = Inputs.from_file(PWFA, overrides=[
        "max_step=100", "amr.n_cell=16 16 16",
        "driver.num_particles=500", "witness.num_particles=500",
        "hipace.dt=1e-12", "hipace.nt_per_betatron=0",
        "hipace.max_time=2.5e-12",
        f"hipace.file_prefix={tmp_path}/mt",
        "diagnostic.output_period=0"])
    # disable adaptive dt by setting a fixed dt
    inputs.override("hipace.dt", "1e-12")
    sim = Simulation(inputs, verbose=0)
    steps = []
    orig = sim.run_step

    def spy(step):
        steps.append((step, sim.time, sim.dt))
        return orig(step)

    sim.run_step = spy
    sim.evolve(write_output=False)
    # t: 0, 1e-12, 2e-12 (dt clamped to 0.5e-12), 2.5e-12 (dt=0), stop
    assert len(steps) == 4
    assert steps[2][2] == pytest.approx(0.5e-12)
    assert steps[3][1] == pytest.approx(2.5e-12) and steps[3][2] == 0.0


def test_lwfa_deck(tmp_path):
    inputs = Inputs.from_file(LWFA, overrides=[
        "max_step=1", "amr.n_cell=32 32 48",
        f"hipace.file_prefix={tmp_path}/lwfa",
        "diagnostic.output_period=1"])
    sim = Simulation(inputs, verbose=0)
    # the multi-line quoted density with if() parsed into one expression
    expr = sim.plasma_cfgs[0].density_expr
    assert "where(" in expr and "Lramp" in expr
    sim.evolve()
    import h5py
    with h5py.File(f"{tmp_path}/lwfa/openpmd_000001.h5", "r") as f:
        ez = np.asarray(f["data/1/fields/Ez"])
        env = np.asarray(f["data/1/fields/laser_diag/laserEnvelope"])
    assert np.all(np.isfinite(ez))
    assert np.abs(ez).max() > 0          # laser drives a wake
    assert np.abs(env).max() == pytest.approx(1.9, rel=0.15)  # a0 = 1.9
