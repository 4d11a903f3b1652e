"""Occupancy-scaled chunked beam ops == whole-capacity processing.

hipace.beam_chunk processes beam lanes in dynamic-trip-count while_loop
chunks (see particles/beam.py chunk_apply) so per-slice cost scales with
the actual particle count instead of the peak-sized capacity. Default-off
(occupancy buckets, hipace.beam_buckets, are the default mechanism); these
tests pin exact equivalence with the unchunked path so the option stays
sound.
"""

import jax
import jax.numpy as jnp
import numpy as np

from hipace_tpu.parser import Inputs
from hipace_tpu.pipeline.simulation import Simulation

DECK = """
amr.n_cell = 32 32 24
hipace.normalized_units = 1
max_step = 1
hipace.dt = 2.0
boundary.field = Dirichlet
boundary.particle = Absorbing
geometry.prob_lo = -6. -6. -6.
geometry.prob_hi =  6.  6.  4.
beams.names = beam
beam.injection_type = fixed_weight
beam.num_particles = 4000
beam.profile = gaussian
beam.position_mean = 0. 0. -1.
beam.position_std = 0.4 0.4 1.2
beam.zmin = -5.9
beam.zmax = 3.9
beam.density = 2.
beam.u_mean = 0. 0. 1000.
beam.u_std = 0. 0. 10.
plasmas.names = plasma
plasma.density(x,y,z) = 1.
plasma.ppc = 1 1
plasma.element = electron
diagnostic.output_period = 1
hipace.file_prefix = {prefix}
"""


def _run(tmp_path, tag, extra):
    prefix = str(tmp_path / tag)
    inputs = Inputs(DECK.format(prefix=prefix), overrides=extra)
    sim = Simulation(inputs, verbose=0)
    sim.evolve()
    import h5py
    with h5py.File(f"{prefix}/openpmd_000001.h5") as f:
        ez = np.array(f["data/1/fields/Ez"])
        uz = np.sort(np.array(f["data/1/particles/beam/momentum/z"]))
        x = np.sort(np.array(f["data/1/particles/beam/position/x"]))
    return ez, uz, x


def test_chunked_beam_matches_unchunked(tmp_path):
    ez0, uz0, x0 = _run(tmp_path, "ref", ["hipace.beam_chunk=0"])
    ez1, uz1, x1 = _run(tmp_path, "chk", ["hipace.beam_chunk=512"])
    np.testing.assert_allclose(ez1, ez0, rtol=1e-12, atol=1e-12)
    np.testing.assert_allclose(uz1, uz0, rtol=1e-12, atol=1e-12)
    np.testing.assert_allclose(x1, x0, rtol=1e-12, atol=1e-12)


def test_chunk_apply_partial_tail():
    """chunk_apply must process exactly the lanes below n_active and leave
    the tail untouched, including the padded remainder chunk."""
    from hipace_tpu.particles.beam import chunk_apply

    N, CH = 1000, 128
    arrs = {"a": jnp.arange(N, dtype=jnp.float32),
            "valid": jnp.arange(N) < 700}
    out = chunk_apply(arrs, jnp.asarray(700), CH,
                      lambda ch: {"a": ch["a"] + 1.0})
    expect_upto = ((700 + CH - 1) // CH) * CH  # whole chunks covering 700
    a = np.asarray(out["a"])
    np.testing.assert_allclose(a[:expect_upto],
                               np.arange(expect_upto) + 1.0)
    np.testing.assert_allclose(a[expect_upto:],
                               np.arange(expect_upto, N))


def test_chunk_reduce_accumulates():
    from hipace_tpu.particles.beam import chunk_reduce

    N, CH = 512, 64
    arrs = {"v": jnp.ones((N,), jnp.float32)}
    total = chunk_reduce(arrs, jnp.asarray(300), CH,
                         jnp.zeros((), jnp.float32),
                         lambda acc, ch: acc + jnp.sum(ch["v"]))
    # 300 active -> ceil(300/64) = 5 chunks = 320 lanes summed
    assert float(total) == 320.0
