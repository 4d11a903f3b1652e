"""Banded one-hot kernels composed with ionization and the AB5 pusher.

Round-1 restriction lifts (the reference composes its full option matrix
freely, ref PlasmaDepositCurrent.cpp:96-121): the argsort row sort permutes
every plasma attribute — ion_lev and the 25 AB5 force-history slots ride
along — and ionization spawning switches to append-mode slots that survive
re-ordering of the parent array.
"""

import numpy as np

from hipace_tpu.parser import Inputs
from hipace_tpu.pipeline.simulation import Simulation

# ionization draws are keyed to the persistent particle id, so the ionized
# set is identical between the banded (row-sorted) and unbanded paths and
# the runs agree to summation-order roundoff
ION_DECK = """
amr.n_cell = 32 32 40
my_constants.ne = 1.25e24
my_constants.wp = sqrt(ne * q_e^2 / (epsilon0 * m_e))
my_constants.kp = wp / clight
my_constants.kp_inv = 1. / kp
max_step = 0
hipace.dt = 0.
hipace.depos_order_xy = 2
boundary.field = Dirichlet
boundary.particle = Periodic
geometry.prob_lo = -20.e-6 -20.e-6 -30.e-6
geometry.prob_hi =  20.e-6  20.e-6  30.e-6
beams.names = beam
beam.injection_type = fixed_ppc
beam.profile = flattop
beam.zmin = 25.e-6 - 2. * kp_inv
beam.zmax = 25.e-6
beam.radius = kp_inv / 2
beam.density = 12. * ne
beam.u_mean = 0. 0. 2000
beam.u_std = 0. 0. 0.
beam.ppc = 1 1 1
plasmas.names = elec ion
elec.density(x,y,z) = ne
elec.ppc = 0 0
elec.element = electron
elec.neutralize_background = false
ion.density(x,y,z) = ne
ion.ppc = 1 1
ion.element = H
ion.mass_Da = 1.008
ion.initial_ion_level = 0
ion.ionization_product = elec
hipace.random_seed = 3
diagnostic.output_period = 0
"""

AB5_DECK = """
hipace.normalized_units = 1
amr.n_cell = 32 32 24
hipace.dt = 0.7
hipace.verbose = 0
hipace.plasma_pusher = ab5
geometry.prob_lo = -8. -8. -6.
geometry.prob_hi =  8.  8.  6.
max_step = 1
beams.names = beam
beam.injection_type = fixed_weight
beam.num_particles = 4000
beam.density = 1.
beam.u_mean = 0. 0. 2000.
beam.u_std = 0. 0. 0.
beam.position_mean = 0. 0. 0.
beam.position_std = 0.3 0.3 1.41
beam.do_symmetrize = 0
plasmas.names = elec
elec.density(x,y,z) = 1.
elec.ppc = 2 1
elec.element = electron
hipace.random_seed = 7
diagnostic.output_period = 0
"""


def _run(deck, banded):
    inputs = Inputs(deck, overrides=[f"hipace.use_banded={int(banded)}",
                                     "hipace.banded_W=4096",
                                     "hipace.banded_K=1024"])
    sim = Simulation(inputs, verbose=0)
    res = sim.run_step(0)
    return sim, res


def test_banded_ionization_matches_unbanded():
    sim_r, ref = _run(ION_DECK, False)
    sim_b, ban = _run(ION_DECK, True)
    dref = np.asarray(ref["diag"])
    dban = np.asarray(ban["diag"])
    scale = np.max(np.abs(dref)) + 1e-30
    assert np.max(np.abs(dban - dref)) / scale < 1e-8
    assert "spawn_lost" in ban and int(ban["spawn_lost"]) == 0


def test_banded_ab5_matches_unbanded():
    _, ref = _run(AB5_DECK, False)
    _, ban = _run(AB5_DECK, True)
    dref = np.asarray(ref["diag"])
    dban = np.asarray(ban["diag"])
    scale = np.max(np.abs(dref)) + 1e-30
    assert np.max(np.abs(dban - dref)) / scale < 1e-10
    vr = np.asarray(ref["binned"]["valid"])
    vb = np.asarray(ban["binned"]["valid"])
    np.testing.assert_array_equal(vr, vb)
    for k in ("x", "y", "uz"):
        a = np.asarray(ref["binned"][k]) * vr
        b = np.asarray(ban["binned"][k]) * vr
        s = np.max(np.abs(a)) + 1e-30
        assert np.max(np.abs(a - b)) / s < 1e-10, k
