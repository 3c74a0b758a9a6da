"""The GPU entry points as seen from a machine without a GPU: the smoke
script refuses to run, the compile cache lands where it should, and the
card-only check skips."""

import os
import shutil
import subprocess
import sys

import numpy as np
import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _env(**extra):
    env = {k: v for k, v in os.environ.items() if k != "JAX_COMPILATION_CACHE_DIR"}
    env["JAX_PLATFORMS"] = "cpu"
    env.update(extra)
    return env


def test_chip_smoke_refuses_cpu():
    p = subprocess.run(
        [sys.executable, os.path.join(REPO, "chip_smoke.py"), "--sf", "0.001"],
        capture_output=True, text=True, timeout=300, env=_env(), cwd=REPO,
    )
    assert p.returncode != 0
    assert '"ok"' not in p.stdout
    assert "needs a GPU" in p.stderr


def test_chip_smoke_alone_fails(tmp_path):
    shutil.copy(os.path.join(REPO, "chip_smoke.py"), tmp_path)
    env = _env()
    env.pop("PYTHONPATH", None)
    p = subprocess.run(
        [sys.executable, "chip_smoke.py"],
        capture_output=True, text=True, timeout=300, env=env, cwd=tmp_path,
    )
    assert p.returncode != 0
    assert '"ok"' not in p.stdout


_PRINT_CACHE = (
    "import jax, strawboat.kernels; print(jax.config.jax_compilation_cache_dir)"
)


def test_compile_cache_follows_env(tmp_path):
    want = str(tmp_path / "cache")
    p = subprocess.run(
        [sys.executable, "-c", _PRINT_CACHE], capture_output=True, text=True,
        timeout=300, cwd=tmp_path,
        env=_env(JAX_COMPILATION_CACHE_DIR=want, PYTHONPATH=REPO),
    )
    assert p.returncode == 0, p.stderr
    assert p.stdout.strip() == want


def test_compile_cache_default_is_in_checkout(tmp_path):
    env = _env(PYTHONPATH=REPO)
    p = subprocess.run(
        [sys.executable, "-c", _PRINT_CACHE], capture_output=True, text=True,
        timeout=300, env=env, cwd=tmp_path,
    )
    assert p.returncode == 0, p.stderr
    assert p.stdout.strip() == os.path.join(REPO, ".jax_cache")
    with open(os.path.join(REPO, ".gitignore")) as f:
        assert ".jax_cache/" in f.read().split()


@pytest.mark.gpu
@pytest.mark.parametrize("b", [1, 7, 16, 31, 32])
def test_plane_unpack_on_gpu(gpu_device, b):
    """The plane unpack as the GPU compiles it, at a real tile width."""
    import jax

    from strawboat.exec.resident import TILE3D, _pack_plane, _unpack_plane_tiled

    vals = np.random.default_rng(b).integers(0, 1 << b, 1 << 20, dtype=np.uint64)
    vals = vals.astype(np.uint32)
    wt3 = jax.device_put(_pack_plane(vals, b, TILE3D), gpu_device)
    got = jax.jit(_unpack_plane_tiled, static_argnums=1)(wt3, b)
    assert np.array_equal(np.asarray(got)[: vals.size], vals)
    assert not np.asarray(got)[vals.size:].any()
