"""Test config: force JAX onto a virtual 8-device CPU mesh.

Must run before any ``import jax`` (pytest imports conftest first).  Tests
that need the card carry the ``gpu`` marker and skip here; on the GPU,
``python chip_smoke.py`` runs what they cover, and bench.py measures.
"""

import os
import sys

os.environ["JAX_PLATFORMS"] = "cpu"
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8"
    ).strip()

# backend selection is lazy: setting the config before any computation wins
# over whatever the environment pinned
import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np
import pyarrow as pa
import pytest


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "gpu: needs a GPU; skips elsewhere (chip_smoke.py runs it)"
    )


@pytest.fixture
def gpu_device():
    """The first GPU, or a skip: decided when the test runs, never at
    import, so every xdist worker collects the same tests."""
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        pytest.skip(f"needs a GPU; JAX runs on {dev.platform} here")
    return dev


# ---------------------------------------------------------------------------
# seeded random chunk generators (mirrors tests/it/io.rs:343-415: seed 42,
# controlled null density + cardinality)

SEED = 42
PAGE_SIZE = 2048


def rng():
    return np.random.default_rng(SEED)


def create_random_index(size: int, null_density: float, cardinality: int, r=None):
    r = r or rng()
    vals = r.integers(0, cardinality, size)
    mask = r.random(size) >= null_density
    return pa.array(
        [int(v) if m else None for v, m in zip(vals, mask)], type=pa.int32()
    )


def create_random_i64(size: int, null_density: float, r=None):
    r = r or rng()
    vals = r.integers(-(10**12), 10**12, size)
    mask = r.random(size) >= null_density
    return pa.array(
        [int(v) if m else None for v, m in zip(vals, mask)], type=pa.int64()
    )


def create_random_double(size: int, null_density: float, r=None):
    r = r or rng()
    vals = r.normal(0, 1e6, size)
    mask = r.random(size) >= null_density
    return pa.array(
        [float(v) if m else None for v, m in zip(vals, mask)], type=pa.float64()
    )


def create_random_bool(size: int, null_density: float, r=None):
    r = r or rng()
    vals = r.random(size) > 0.5
    mask = r.random(size) >= null_density
    return pa.array(
        [bool(v) if m else None for v, m in zip(vals, mask)], type=pa.bool_()
    )


def create_random_string(size: int, null_density: float, cardinality: int, r=None):
    r = r or rng()
    vals = r.integers(0, cardinality, size)
    mask = r.random(size) >= null_density
    return pa.array(
        [f"value-{v}" if m else None for v, m in zip(vals, mask)],
        type=pa.string(),
    )


def create_random_offsets(size: int, max_run: int, r=None):
    r = r or rng()
    lens = r.integers(0, max_run, size)
    offs = np.zeros(size + 1, dtype=np.int32)
    np.cumsum(lens, out=offs[1:])
    return offs


@pytest.fixture
def tmp_strawboat(tmp_path):
    return str(tmp_path / "test.str")
