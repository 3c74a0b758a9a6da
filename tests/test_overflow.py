"""Capacity-overflow behavior: never silently wrong.

Round-1 verdict items: shuffle bins dropped rows past capacity, aggregate
collapsed overflow groups into the last slot, joins truncated matches past
max_fanout — all silently.  These tests force each overflow and assert
grow-and-retry correctness (default) or CapacityError (on_overflow="raise").
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import pyarrow as pa

from strawboat.errors import CapacityError
from strawboat.exec.aggregate import hash_aggregate
from strawboat.exec.join import hash_join
from strawboat.exec.scan import DeviceColumn, DeviceTable
from strawboat.parallel import distributed_aggregate, make_mesh, shuffle_by_key


@pytest.fixture(scope="module")
def mesh():
    assert jax.device_count() >= 8
    return make_mesh(8)


def _shard(mesh, arr):
    from jax.sharding import NamedSharding, PartitionSpec as P

    return jax.device_put(arr, NamedSharding(mesh, P("shards")))


def _table(**cols):
    n = 0
    out = {}
    for name, v in cols.items():
        arr = jnp.asarray(v)
        out[name] = DeviceColumn(name, pa.int64(), arr, None)
        n = arr.shape[0]
    return DeviceTable(out, n)


# -- shuffle ----------------------------------------------------------------


def test_shuffle_overflow_grows(mesh):
    """One hot key sends every row to a single bin; capacity 8 must grow."""
    n = 8 * 64
    key = jnp.zeros(n, dtype=jnp.int64)
    val = jnp.arange(n, dtype=jnp.int64)
    out_key, (out_val,), valid = shuffle_by_key(
        mesh, "shards", _shard(mesh, key), (_shard(mesh, val),), capacity=8
    )
    v = np.asarray(valid)
    assert int(v.sum()) == n  # every row survived
    assert sorted(np.asarray(out_val)[v].tolist()) == list(range(n))


def test_shuffle_overflow_raises(mesh):
    n = 8 * 64
    key = jnp.zeros(n, dtype=jnp.int64)
    val = jnp.arange(n, dtype=jnp.int64)
    with pytest.raises(CapacityError):
        shuffle_by_key(
            mesh,
            "shards",
            _shard(mesh, key),
            (_shard(mesh, val),),
            capacity=8,
            on_overflow="raise",
        )


# -- local aggregate ----------------------------------------------------------


def test_hash_aggregate_overflow_grows():
    rng = np.random.default_rng(11)
    n = 4096
    key = rng.integers(0, 300, n).astype(np.int64)  # 300 groups > capacity 16
    val = rng.integers(0, 10**6, n).astype(np.int64)
    t = _table(k=key, v=val)
    res = hash_aggregate(t, ["k"], {"total": ("sum", "v")}, num_groups=16)
    n_groups = int(res["n_groups"])
    assert n_groups == len(np.unique(key))
    got = {
        int(k): int(s)
        for k, s in zip(
            np.asarray(res["key_k"])[:n_groups], np.asarray(res["total"])[:n_groups]
        )
    }
    exp = {int(k): int(val[key == k].sum()) for k in np.unique(key)}
    assert got == exp


def test_hash_aggregate_overflow_raises():
    key = np.arange(100, dtype=np.int64)
    t = _table(k=key, v=key)
    with pytest.raises(CapacityError):
        hash_aggregate(
            t, ["k"], {"total": ("sum", "v")}, num_groups=16, on_overflow="raise"
        )


# -- join fan-out -------------------------------------------------------------


def test_hash_join_fanout_grows():
    """Build keys repeat 7× but max_fanout stays at the default 1."""
    probe = _table(k=np.array([1, 2, 3], dtype=np.int64))
    bk = np.repeat(np.array([1, 2, 3], dtype=np.int64), 7)
    build = _table(k=bk, w=np.arange(21, dtype=np.int64))
    pi, bi, valid = hash_join(probe, build, on=("k", "k"), max_fanout=1)
    v = np.asarray(valid)
    assert int(v.sum()) == 21  # all 3×7 matches, none truncated
    # every build row matched exactly once
    assert sorted(np.asarray(bi)[v].tolist()) == list(range(21))


def test_hash_join_fanout_raises():
    probe = _table(k=np.array([1], dtype=np.int64))
    build = _table(k=np.array([1, 1, 1], dtype=np.int64))
    with pytest.raises(CapacityError):
        hash_join(probe, build, on=("k", "k"), max_fanout=1, on_overflow="raise")


# -- distributed ----------------------------------------------------------------


def test_distributed_aggregate_overflow_grows(mesh):
    rng = np.random.default_rng(23)
    n = 8 * 512
    key = rng.integers(0, 600, n).astype(np.int64)  # 600 groups > capacity 32
    val = rng.integers(0, 10**5, n).astype(np.int64)
    res = distributed_aggregate(
        mesh,
        "shards",
        _shard(mesh, jnp.asarray(key)),
        {"total": ("sum", _shard(mesh, jnp.asarray(val)))},
        num_groups=32,
    )
    got = {}
    for kk, t, ok in zip(
        np.asarray(res["keys"]), np.asarray(res["total"]), np.asarray(res["valid"])
    ):
        if ok:
            assert int(kk) not in got
            got[int(kk)] = int(t)
    exp = {int(k): int(val[key == k].sum()) for k in np.unique(key)}
    assert got == exp


def test_distributed_join_fanout_grows(mesh):
    from strawboat.parallel.dist_join import distributed_join

    rng = np.random.default_rng(29)
    n, m = 8 * 128, 8 * 32
    pk = rng.integers(0, 40, n).astype(np.int64)
    pv = rng.integers(0, 1000, n).astype(np.int64)
    bk = rng.integers(0, 40, m).astype(np.int64)  # duplicate build keys
    bw = rng.integers(1, 10, m).astype(np.int64)
    key, out_p, out_b, valid = distributed_join(
        mesh,
        "shards",
        _shard(mesh, jnp.asarray(pk)),
        (_shard(mesh, jnp.asarray(pv)),),
        _shard(mesh, jnp.asarray(bk)),
        (_shard(mesh, jnp.asarray(bw)),),
        capacity_per_shard=256,
        max_fanout=1,  # true max fan-out is much larger — must grow
    )
    v = np.asarray(valid)
    got = int((np.asarray(out_p[0])[v] * np.asarray(out_b[0])[v]).sum())
    exp = 0
    n_matches = 0
    for k, val in zip(pk, pv):
        sel = bk == k
        exp += int(val) * int(bw[sel].sum())
        n_matches += int(sel.sum())
    assert int(v.sum()) == n_matches
    assert got == exp


def test_pipelined_aggregate_overflow_raises(mesh):
    from strawboat.parallel.pipeline import pipelined_distributed_aggregate

    rng = np.random.default_rng(31)
    per_chunk = 8 * 256
    chunks = []
    for _ in range(2):
        k = rng.integers(0, 500, per_chunk).astype(np.int64)  # 500 > 32 groups
        v = rng.integers(0, 100, per_chunk).astype(np.int64)
        chunks.append(
            (
                _shard(mesh, jnp.asarray(k)),
                {"total": ("sum", _shard(mesh, jnp.asarray(v)))},
                None,
            )
        )
    with pytest.raises(CapacityError):
        pipelined_distributed_aggregate(mesh, "shards", chunks, num_groups=32)
