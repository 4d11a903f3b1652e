"""Round-3 regression tests for config-default consistency.

- The effective default banded window must be the measured-best W=32 with
  auto-K sized for the SAME W (VERDICT r2: simulation.py defaulted W=16
  while auto-K sized for 32 — a silent perf regression).
- do_symmetrize with num_particles % 4 != 0 must hard-error like the
  reference (ref BeamParticleContainer.cpp:176), not silently truncate.
"""

import pytest

from hipace_tpu.parser import Inputs
from hipace_tpu.pipeline.simulation import Simulation
from hipace_tpu.pipeline.step import SimConfig

_DECK = """
amr.n_cell = 256 256 8
hipace.normalized_units = 1
max_step = 0
hipace.dt = 1.0
boundary.field = Dirichlet
boundary.particle = Periodic
geometry.prob_lo = -8. -8. -6.
geometry.prob_hi =  8.  8.  2.
beams.names = beam
beam.injection_type = fixed_weight
beam.num_particles = {npart}
beam.profile = gaussian
beam.position_mean = 0. 0. -1.
beam.position_std = 0.3 0.3 1.41
beam.density = 3.
beam.u_mean = 0. 0. 2000.
beam.u_std = 0. 0. 0.
{beam_extra}
plasmas.names = plasma
plasma.density(x,y,z) = 1.
plasma.ppc = 1 1
plasma.element = electron
diagnostic.output_period = 0
"""


def _sim(npart=1024, beam_extra=""):
    return Simulation(Inputs(_DECK.format(npart=npart,
                                          beam_extra=beam_extra)),
                      verbose=0)


def test_default_banded_w_is_32_and_k_sized_for_it():
    sim = _sim()
    # the scatter path is the default at every size (PERF.md: one-hot
    # measured 12x slower on the H100)
    assert not sim.cfg.use_banded
    sim = _sim(beam_extra="hipace.use_banded = 1\n")
    assert sim.cfg.use_banded
    assert sim.cfg.banded_W == SimConfig.banded_W == 32
    # auto-K must have been sized for the SAME W: K <= (W-11)*nx and is
    # the largest power of two <= min(8192, cap)
    cap = max(256, (sim.cfg.banded_W - 11) * sim.geom.nx)
    k = 256
    while k * 2 <= min(8192, cap):
        k *= 2
    assert sim.cfg.banded_K == k
    assert sim.cfg.banded_gather_K == k


def test_banded_w_override_consistent_k():
    sim = _sim(beam_extra="hipace.banded_W = 16\n")
    assert sim.cfg.banded_W == 16
    cap = max(256, (16 - 11) * sim.geom.nx)
    k = 256
    while k * 2 <= min(8192, cap):
        k *= 2
    assert sim.cfg.banded_K == k


def test_do_symmetrize_requires_divisible_by_4():
    with pytest.raises(ValueError, match="do_symmetrize"):
        _sim(npart=1023, beam_extra="beam.do_symmetrize = 1\n")
    # divisible count still works
    sim = _sim(npart=1024, beam_extra="beam.do_symmetrize = 1\n")
    assert sim.beam_cfgs[0].do_symmetrize


def test_sort_period_auto_default():
    """banded_sort_period=0 (the default) resolves to 2 without ionization
    and to 1 with an ionizing species (append-mode spawning needs
    per-slice compaction).
    Exactness never depends on the period (corrective pass)."""
    sim = _sim()
    assert sim.cfg.banded_sort_period == 2
    sim = _sim(beam_extra="hipace.banded_sort_period = 1\n")
    assert sim.cfg.banded_sort_period == 1
    # ionizing species (appended AFTER the template so plasmas.names wins)
    deck = _DECK.format(npart=1024, beam_extra="") + (
        "plasmas.names = plasma ions elec2\n"
        "hipace.background_density_SI = 1e23\n"
        "ions.density(x,y,z) = 1.\n"
        "ions.ppc = 1 1\n"
        "ions.element = He\n"
        "ions.initial_ion_level = 1\n"
        "ions.ionization_product = elec2\n"
        "elec2.element = electron\n"
        "elec2.ppc = 0 0\n"
        "elec2.density(x,y,z) = 0.\n"
        "elec2.initial_ion_level = 2\n"
    )
    ion = Simulation(Inputs(deck), verbose=0)
    assert ion.ionization_pairs
    assert ion.cfg.banded_sort_period == 1
