"""Device policy: f32 contraction precision, compile-cache placement and
the openPMD h5 backend's dependency."""

import os
import re
import sys

import jax
import jax.numpy as jnp
import pytest

from hipace_tpu.parser import Inputs
from hipace_tpu.pipeline.simulation import Simulation
from hipace_tpu.utils import backend

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_BASE = """
amr.n_cell = 32 32 8
hipace.normalized_units = 1
hipace.dt = 1.
geometry.prob_lo = -8. -8. -6.
geometry.prob_hi = 8. 8. 2.
beams.names = beam
beam.injection_type = fixed_weight
beam.num_particles = 512
beam.position_mean = 0. 0. -1.
beam.position_std = 0.3 0.3 1.
beam.density = 3.
beam.u_mean = 0. 0. 2000.
beam.u_std = 0. 0. 0.
plasmas.names = plasma
plasma.density(x,y,z) = 1.
plasma.ppc = 1 1
diagnostic.output_period = 0
"""

# every layer with an f32 contraction: the banded one-hot kernels and the
# multigrid transfers (explicit solver), and the MR level coupling plus
# the laser <-> field grid interpolation
_DECKS = {
    "banded_explicit": _BASE + """
hipace.use_banded = 1
hipace.banded_K = 256
hipace.banded_gather_K = 256
""",
    "mr_laser_grid": _BASE + """
amr.max_level = 1
mr_lev1.n_cell = 16 16
mr_lev1.patch_lo = -2. -2. -6.
mr_lev1.patch_hi = 2. 2. 2.
lasers.names = laser
lasers.lambda0 = 0.8e-6
lasers.n_cell = 24 24
lasers.patch_lo = -6. -6. -6.
lasers.patch_hi = 6. 6. 2.
laser.a0 = 0.5
laser.w0 = 3.
laser.L0 = 1.
laser.position_mean = 0. 0. -1.
""",
}

_DOT = re.compile(r"stablehlo\.dot(_general)?\b")


@pytest.mark.parametrize("name", sorted(_DECKS))
def test_slice_step_f32_dots_are_highest(name):
    """Without an explicit precision an f32 matmul may run as TF32 on the
    GPU: every f32 dot of the lowered time step must carry HIGHEST."""
    sim = Simulation(Inputs(_DECKS[name]), dtype=jnp.float32, verbose=0)

    def step(binned, t, dt, key):
        return sim._time_step(binned, t, dt, key)

    text = jax.jit(step).lower(sim.binned, jnp.float32(0), jnp.float32(1),
                               jax.random.PRNGKey(0)).as_text()
    dots = [ln for ln in text.splitlines() if _DOT.search(ln)]
    f32 = [ln for ln in dots if "xf32>" in ln or "complex<f32>" in ln]
    assert f32, f"{name}: no f32 dot found in the lowered step"
    bad = [ln.strip() for ln in f32
           if "precision = [HIGHEST, HIGHEST]" not in ln]
    assert not bad, f"{name}: f32 dots without HIGHEST: {bad[:3]}"


def test_compile_cache_default_is_checkout(monkeypatch):
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    monkeypatch.setattr(jax.config, "update", _recorder := _Recorder())
    backend.enable_compilation_cache()
    assert backend.DEFAULT_CACHE_DIR == os.path.join(REPO, ".jax_cache")
    assert backend.compilation_cache_dir() == backend.DEFAULT_CACHE_DIR
    assert _recorder.calls == [("jax_compilation_cache_dir",
                                backend.DEFAULT_CACHE_DIR)]


def test_compile_cache_env_sets_nothing(monkeypatch, tmp_path):
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    monkeypatch.setattr(jax.config, "update", _recorder := _Recorder())
    backend.enable_compilation_cache()
    assert backend.compilation_cache_dir() == str(tmp_path)
    assert _recorder.calls == []


class _Recorder:
    def __init__(self):
        self.calls = []

    def __call__(self, name, value):
        self.calls.append((name, value))


def test_openpmd_h5_without_h5py_raises(monkeypatch, tmp_path):
    from hipace_tpu.diagnostics.openpmd import OpenPMDWriter
    monkeypatch.setitem(sys.modules, "h5py", None)   # import fails
    with pytest.raises(RuntimeError, match="h5py"):
        OpenPMDWriter(str(tmp_path / "h5"), backend="h5")
    w = OpenPMDWriter(str(tmp_path / "json"), backend="json")
    assert w.backend == "json"
