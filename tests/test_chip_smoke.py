"""chip_smoke.py: its refusals, its result line, and a rehearsal of every
phase on the CPU at tiny sizes without h5py (as on a machine that lacks
it), so a wrong path, argument or check shows here before the card."""

import json
import os
import shutil
import subprocess
import sys
import types

import jax
import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import chip_smoke  # noqa: E402


def _run_smoke(cwd, *args):
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    return subprocess.run([sys.executable, "chip_smoke.py", *args],
                          cwd=cwd, env=env, capture_output=True, text=True,
                          timeout=300)


@pytest.mark.parametrize("args", [(), ("--four",)], ids=["one", "four"])
def test_refuses_cpu(args):
    r = _run_smoke(REPO, *args)
    assert r.returncode != 0
    assert '"ok"' not in r.stdout
    assert "no GPU" in r.stderr


def test_refuses_outside_checkout(tmp_path):
    shutil.copy(os.path.join(REPO, "chip_smoke.py"), tmp_path)
    r = _run_smoke(str(tmp_path))
    assert r.returncode != 0
    assert '"ok"' not in r.stdout


def test_result_line_contract():
    dev = types.SimpleNamespace(platform="gpu",
                                device_kind="NVIDIA H100 80GB HBM3")
    line = chip_smoke.result_line([dev])
    assert "\n" not in line
    assert json.loads(line) == {"ok": True, "device": {
        "platform": "gpu", "kind": "NVIDIA H100 80GB HBM3", "count": 1}}
    assert json.loads(chip_smoke.result_line([dev] * 4))["device"][
        "count"] == 4


@pytest.fixture
def no_h5py(monkeypatch):
    monkeypatch.setitem(sys.modules, "h5py", None)   # import fails


def test_rehearse_main_path(no_h5py, tmp_path):
    m = chip_smoke.phase_main_path("cpu", str(tmp_path), nxy=63, nz=32,
                                   max_step=3)
    assert m["slices_per_s"] > 0 and not m["use_banded"]
    assert os.path.isfile(tmp_path / "main_path" / "openpmd_000003.json")


def test_rehearse_kernels(no_h5py):
    chip_smoke.phase_kernels("cpu", nxy=127, K=1024)


def test_rehearse_physics(no_h5py):
    chip_smoke.phase_physics("cpu", nxy=63, nz=32)


def test_rehearse_four(no_h5py):
    assert len(jax.devices()) >= 4, "needs the virtual CPU mesh"
    chip_smoke.phase_four("cpu", nxy=31, nz=32, npart=4000)


def test_kernel_bound_catches_tf32(monkeypatch):
    """A one-hot product in reduced precision must fail the kernel check:
    run the one-hot deposit with its dots at DEFAULT precision on
    bf16-rounded operands (what TF32 would keep is between the two)."""
    import jax.numpy as jnp

    from hipace_tpu.ops import banded
    real = jax.lax.dot_general

    def low(a, b, dims, precision=None, preferred_element_type=None):
        return real(a.astype(jnp.bfloat16), b.astype(jnp.bfloat16), dims,
                    preferred_element_type=preferred_element_type)

    monkeypatch.setattr(banded.jax.lax, "dot_general", low)
    with pytest.raises(chip_smoke.SmokeError, match="deposit order 0"):
        chip_smoke.phase_kernels("cpu", nxy=63, K=1024)


@pytest.mark.gpu
def test_kernels_on_gpu():
    """The kernel phase of chip_smoke.py at a reduced width, on the card."""
    if jax.devices()[0].platform != "gpu":
        pytest.skip("needs a CUDA GPU (run chip_smoke.py on the card)")
    chip_smoke.phase_kernels("gpu", nxy=255, K=2048)
