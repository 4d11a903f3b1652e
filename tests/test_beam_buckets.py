"""Occupancy-bucketed beam ops (beam.py prefix_ladder/prefix_apply/
prefix_reduce, wired through step.py via hipace.beam_buckets).

The per-slice beam arrays are sized to the PEAK slice; a gaussian beam
runs at ~15% mean occupancy, so round 5 wraps every beam op in a
lax.switch over a halving ladder of static lane prefixes (the reference
sizes its slice tiles exactly instead — ref
BeamParticleContainer.H:162-189 / BeamParticleAdvance.cpp:60
ParallelFor(num_particles)). Bucketing must be bit-identical on the
scatter path (prefix truncation only removes invalid lanes and preserves
live-lane order) and physics-identical end-to-end.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import decks
from hipace_tpu.particles import beam as bm


def test_prefix_ladder():
    assert bm.prefix_ladder(8192, 1) == (8192,)
    lad = bm.prefix_ladder(66560, 4)
    assert lad[-1] == 66560
    assert all(a < b for a, b in zip(lad, lad[1:]))
    assert all(s % 1024 == 0 or s == 66560 for s in lad)
    # small capacity: quantum floor collapses the ladder
    assert bm.prefix_ladder(800, 4) == (800,)
    assert bm.prefix_ladder(2048, 4) == (1024, 2048)


def test_prefix_index_covers_n_active():
    sizes = bm.prefix_ladder(66560, 4)
    for na in (0, 1, 1024, 5000, sizes[0], sizes[0] + 1, sizes[-2],
               sizes[-1]):
        idx = int(bm._prefix_index(jnp.asarray(na, jnp.int32), sizes))
        assert sizes[idx] >= na, (na, sizes, idx)


@pytest.mark.parametrize("na", [0, 100, 1024, 3000, 8192])
def test_prefix_apply_matches_full(na):
    N = 8192
    rng = np.random.default_rng(0)
    arrs = {"a": jnp.asarray(rng.normal(size=N)),
            "b": jnp.asarray(rng.normal(size=N))}

    def body(d):
        return {"a": d["a"] * 2.0 + d["b"], "b": d["b"]}

    sizes = bm.prefix_ladder(N, 4)
    got = jax.jit(lambda x: bm.prefix_apply(
        x, jnp.asarray(na, jnp.int32), sizes, body))(arrs)
    # lanes < n_active transformed; the bucket may extend past n_active
    # (static prefix >= n_active) — lanes beyond the SELECTED bucket are
    # untouched
    P = sizes[int(bm._prefix_index(jnp.asarray(na, jnp.int32), sizes))]
    np.testing.assert_array_equal(np.asarray(got["a"][:P]),
                                  np.asarray(arrs["a"][:P] * 2.0
                                             + arrs["b"][:P]))
    np.testing.assert_array_equal(np.asarray(got["a"][P:]),
                                  np.asarray(arrs["a"][P:]))


def test_prefix_reduce_matches_full():
    N = 4096
    rng = np.random.default_rng(1)
    arrs = {"v": jnp.asarray(rng.normal(size=N)),
            "valid": jnp.asarray(np.arange(N) < 900)}
    sizes = bm.prefix_ladder(N, 4)

    def body(acc, d):
        return acc + jnp.sum(jnp.where(d["valid"], d["v"], 0.0))

    got = jax.jit(lambda x: bm.prefix_reduce(
        x, jnp.asarray(900, jnp.int32), sizes, jnp.zeros(()), body))(arrs)
    want = float(jnp.sum(jnp.where(arrs["valid"], arrs["v"], 0.0)))
    assert float(got) == pytest.approx(want, rel=1e-12)


def _run_deck(buckets):
    from hipace_tpu.parser import Inputs
    from hipace_tpu.pipeline.simulation import Simulation
    import tempfile, os
    inputs = Inputs.from_file(
        decks.path("get_started/inputs_normalized"),
        overrides=["max_step=1", "amr.n_cell=32 32 24",
                   "beam.num_particles=4000",
                   f"hipace.beam_buckets={buckets}",
                   "beam.n_subcycles=4",
                   "hipace.verbose=0"])
    with tempfile.TemporaryDirectory() as td:
        inputs.override('hipace.file_prefix', os.path.join(td, 'd'))
        sim = Simulation(inputs, verbose=0)
        sim.evolve()
        import h5py
        with h5py.File(os.path.join(td, "d", "openpmd_000001.h5")) as f:
            ez = np.asarray(f["data/1/fields/Ez"])
            uz = np.asarray(f["data/1/particles/beam/momentum/z"])
    return ez, np.sort(uz)


def test_bucketed_end_to_end_identical():
    """buckets=4 vs buckets=1 (off): identical output on the scatter
    path — prefix truncation removes only invalid lanes and preserves
    live-lane deposit order."""
    ez_b, uz_b = _run_deck(4)
    ez_1, uz_1 = _run_deck(1)
    np.testing.assert_allclose(ez_b, ez_1, rtol=0.0, atol=0.0)
    np.testing.assert_allclose(uz_b, uz_1, rtol=0.0, atol=0.0)


def test_bucketed_banded_end_to_end():
    """buckets x banded kernels: physics equal to the unbucketed banded
    run within f64 summation-order noise (the stripe gap-fill pool
    shrinks with the prefix, so chunk boundaries — and the deposit
    summation order — may differ)."""
    from hipace_tpu.parser import Inputs
    from hipace_tpu.pipeline.simulation import Simulation
    import tempfile, os, h5py

    def run(buckets):
        inputs = Inputs.from_file(
            decks.path("get_started/inputs_normalized"),
            overrides=["max_step=1", "amr.n_cell=32 32 24",
                       "beam.num_particles=4000",
                       f"hipace.beam_buckets={buckets}",
                       "hipace.use_banded=1", "hipace.banded_K=1024",
                       "hipace.banded_gather_K=1024",
                       "hipace.banded_W=4096", "hipace.verbose=0"])
        with tempfile.TemporaryDirectory() as td:
            inputs.override('hipace.file_prefix', os.path.join(td, 'd'))
            sim = Simulation(inputs, verbose=0)
            sim.evolve()
            with h5py.File(os.path.join(td, "d",
                                        "openpmd_000001.h5")) as f:
                ez = np.asarray(f["data/1/fields/Ez"])
        return ez

    np.testing.assert_allclose(run(4), run(1), rtol=1e-10, atol=1e-14)
