"""Banded one-hot kernels composed with mesh refinement.

Level-0 deposits use the banded path while fine-patch deposits/gathers stay
on the XLA scatter path; results must match the fully-unbanded run to
summation-order roundoff (the reference composes MR with everything,
ref PlasmaDepositCurrent.cpp:96-121).
"""

import numpy as np

from hipace_tpu.parser import Inputs
from hipace_tpu.pipeline.simulation import Simulation

from test_mr import BASE, MR


def _run(banded):
    deck = BASE.format(nx=32, extra=MR)
    inputs = Inputs(deck, overrides=[f"hipace.use_banded={int(banded)}",
                                     "hipace.banded_W=4096",
                                     "hipace.banded_K=1024"])
    sim = Simulation(inputs, verbose=0)
    return sim, sim.run_step(0)


def test_banded_mr_matches_unbanded():
    sim_r, ref = _run(False)
    _, ban = _run(True)
    for key in ("diag", "diagf_lev1"):
        a = np.asarray(ref[key])
        b = np.asarray(ban[key])
        scale = np.max(np.abs(a)) + 1e-30
        assert np.max(np.abs(b - a)) / scale < 1e-10, key
