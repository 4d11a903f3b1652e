"""Production composition tests: pipelined × banded (× collisions).

VERDICT r2 item 5: the virtual-device equivalence decks previously ran
only below the banded auto-enable threshold, so the production path
(banded one-hot kernels inside shard_map) never executed in any test. Here
banded is FORCED on the pipeline equivalence deck, and a pipelined
collisions run is pinned statistically (per-device RNG fold-in streams,
like the ionization stats test).
"""

import jax
import numpy as np
import pytest

from hipace_tpu.parser import Inputs
from hipace_tpu.pipeline.simulation import Simulation
from hipace_tpu.parallel.pipeline import pipelined_evolve

# same physics as test_pipeline_parallel.DECK, banded kernels forced
# (W clamped to NY internally; large W disables window drops on 16^2)
DECK = """
amr.n_cell = 16 16 48
hipace.normalized_units = 1
max_step = 1
hipace.dt = 2.0
hipace.depos_order_xy = 2
hipace.use_banded = 1
hipace.banded_W = 4096
hipace.banded_K = 1024
hipace.banded_gather_K = 1024
boundary.field = Dirichlet
boundary.particle = Periodic
geometry.prob_lo = -6. -6. -6.
geometry.prob_hi =  6.  6.  2.
beams.names = beam
beam.injection_type = fixed_weight
beam.num_particles = 2000
beam.profile = gaussian
beam.position_mean = 0. 0. -1.
beam.position_std = 0.3 0.3 1.0
beam.zmin = -5.
beam.zmax = 1.8
beam.density = 1.
beam.u_mean = 0. 0. 1000.
beam.u_std = 0. 0. 0.
plasmas.names = plasma
plasma.density(x,y,z) = 1.
plasma.ppc = 1 1
plasma.element = electron
diagnostic.output_period = 0
"""


@pytest.mark.parametrize("n_dev", [2, 4])
def test_pipelined_banded_matches_serial(n_dev):
    """The banded kernels inside shard_map match the serial steps."""
    devices = jax.devices()
    assert len(devices) >= n_dev, "test needs the virtual CPU mesh"

    ov = [f"max_step={n_dev - 1}"]
    inputs = Inputs(DECK, overrides=ov)
    sim = Simulation(inputs, verbose=0)
    assert sim.cfg.use_banded, "deck must force the banded kernels"
    key = jax.random.PRNGKey(7)

    binned0 = {k: v for k, v in sim.binned.items() if k != "n_dropped"}

    binned = sim.binned
    for step in range(n_dev):
        res = sim._step_fn(binned, sim.dtype(step * sim.dt),
                           sim.dtype(sim.dt), key)
        binned = res["binned"]
    seq_valid = np.asarray(binned["valid"].reshape(-1))
    seq = {k: np.asarray(binned[k].reshape(-1))[seq_valid]
           for k in ("x", "y", "z", "ux", "uy", "uz", "w")}

    final, _min_uz, _laser = pipelined_evolve(sim.cfg, sim.dtype, binned0,
                                              sim.dt, key,
                                              devices=devices[:n_dev])
    pip_valid = np.asarray(final["valid"].reshape(-1))
    pip = {k: np.asarray(final[k].reshape(-1))[pip_valid]
           for k in ("x", "y", "z", "ux", "uy", "uz", "w")}

    assert seq_valid.sum() == pip_valid.sum(), \
        f"particle count mismatch: {seq_valid.sum()} vs {pip_valid.sum()}"

    i_seq = np.argsort(seq["z"], kind="stable")
    i_pip = np.argsort(pip["z"], kind="stable")
    for k in ("x", "y", "z", "ux", "uy", "uz", "w"):
        np.testing.assert_allclose(seq[k][i_seq], pip[k][i_pip],
                                   rtol=1e-9, atol=1e-11, err_msg=k)


# ---- pipelined collisions: statistical equivalence (per-device RNG) ----

COLL_DECK = """
amr.n_cell = 8 8 16
hipace.normalized_units = 1
max_step = 1
hipace.dt = 1.0
hipace.background_density_SI = 1e28
hipace.collisions = c1
c1.species = plasma plasma
boundary.field = Dirichlet
boundary.particle = Periodic
geometry.prob_lo = -4. -4. -8.
geometry.prob_hi =  4.  4.  8.
beams.names = beam
beam.injection_type = fixed_weight
beam.num_particles = 1000
beam.profile = gaussian
beam.position_mean = 0. 0. -1.
beam.position_std = 0.3 0.3 1.0
beam.zmin = -7.
beam.zmax = 7.
beam.density = 1.
beam.u_mean = 0. 0. 1000.
beam.u_std = 0. 0. 0.
plasmas.names = plasma
plasma.density(x,y,z) = 1.
plasma.ppc = 2 2
plasma.element = electron
plasma.u_std = 0.05 0.005 0.005
hipace.random_seed = 5
diagnostic.output_period = 1
diagnostic.diag_type = xz
"""


def test_pipelined_collisions_statistics(tmp_path):
    """Collision kicks use per-device fold-in RNG streams in the pipeline;
    the plasma momentum moments must agree with serial at the statistical
    (not bitwise) level — mirrors the ionization stats test. Ez sums are
    a noise-dominated observable here (the collision-seeded plasma noise
    outweighs the weak test wake), so per-slice <ux^2>/<uy^2> from the
    in-situ reduced diagnostics are pinned instead."""
    import os
    import sys
    sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..",
                                    "tools"))
    import read_insitu_diagnostics as rid
    assert len(jax.devices()) >= 2
    overrides = ["plasmas.insitu_period=1", "diagnostic.output_period=0"]
    cwd = os.getcwd()
    try:
        for sub, pipelined in (("ser", False), ("par", True)):
            d = tmp_path / sub
            d.mkdir()
            os.chdir(d)
            sim = Simulation(Inputs(COLL_DECK, overrides=overrides),
                             verbose=0)
            if pipelined:
                sim.evolve_pipelined(devices=jax.devices()[:2])
            else:
                sim.evolve()
    finally:
        os.chdir(cwd)
    a = rid.read_file(str(tmp_path / "ser/diags/plasma_insitu/"
                          "reduced_plasma.*.txt"))
    b = rid.read_file(str(tmp_path / "par/diags/plasma_insitu/"
                          "reduced_plasma.*.txt"))
    assert a.shape == b.shape and a.shape[0] == 2
    # [ux^2]/[ga] are dominated by the (deterministic) init + wake: tight.
    # [uy^2] grows from the collision kicks themselves (isotropization of
    # the 10:1 anisotropic init), so two independent streams differ at the
    # few-hundred-pair binomial scale: loose — this is the observable that
    # actually proves the pipelined collisions fire.
    for comp, rtol in (("[ux^2]", 0.05), ("[ga]", 0.05), ("[uy^2]", 0.2)):
        sa = float(np.sum(a[comp][-1]))
        sb = float(np.sum(b[comp][-1]))
        assert sa > 0 and sb > 0
        assert abs(sa - sb) / sa < rtol, (comp, sa, sb)
