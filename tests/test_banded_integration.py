"""End-to-end equivalence of the banded one-hot particle path vs scatter.

Runs the same small blowout deck with hipace.use_banded = 0 and 1 (with a
window covering the full grid so nothing can be dropped) and requires the
field diagnostics and beam output to agree to float64 roundoff-level
tolerance. The two paths differ only in summation order.
"""

import numpy as np

from hipace_tpu.parser import Inputs
from hipace_tpu.pipeline.simulation import Simulation


DECK = """
hipace.normalized_units = 1
amr.n_cell = 32 32 24
hipace.dt = 0.7
hipace.verbose = 0
geometry.prob_lo = -8. -8. -6.
geometry.prob_hi =  8.  8.  6.
max_step = 1
beams.names = beam
beam.injection_type = fixed_weight
beam.num_particles = 4000
beam.density = 3.
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
"""


def _run(banded: bool):
    inputs = Inputs(DECK, overrides=[f"hipace.use_banded={int(banded)}",
                                     "hipace.banded_W=4096",
                                     "hipace.banded_K=1024"])
    sim = Simulation(inputs)
    return sim.run_step(0)


def _compare(ref, ban):
    dref = np.asarray(ref["diag"])
    dban = np.asarray(ban["diag"])
    scale = np.max(np.abs(dref)) + 1e-30
    assert np.max(np.abs(dban - dref)) / scale < 1e-10
    # beam output must agree too (same particles, same fields). Lane ORDER
    # is not semantically meaningful (the banded beam path stripe-snake
    # sorts lanes, like the reference's ReorderParticles), so canonicalize
    # by the (unmodified-by-the-push) z position before comparing.
    vr = np.asarray(ref["binned"]["valid"])
    vb = np.asarray(ban["binned"]["valid"])
    assert vr.sum() == vb.sum()

    def canon(res, v):
        z = np.asarray(res["binned"]["z"])[v]
        o = np.argsort(z, kind="stable")
        return {k: np.asarray(res["binned"][k])[v][o]
                for k in ("x", "y", "uz")}

    a_, b_ = canon(ref, vr), canon(ban, vb)
    for k in ("x", "y", "uz"):
        s = np.max(np.abs(a_[k])) + 1e-30
        assert np.max(np.abs(a_[k] - b_[k])) / s < 1e-10, k


def test_banded_path_matches_scatter():
    _compare(_run(False), _run(True))
