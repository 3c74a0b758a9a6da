"""Device kernel unit tests (CPU-forced jax): decode kernels vs host codecs,
encoder stats vs host gen_stats."""

import numpy as np
import pytest

import jax.numpy as jnp

from strawboat.codecs._family import gen_stats
from strawboat.kernels.decode import (
    bitunpack_device,
    dict_gather_device,
    freq_scatter_device,
    one_value_device,
    rle_expand_device,
    unpack_validity_device,
)
from strawboat.kernels.encode import (
    bitpacked_size_bytes,
    block_bit_widths,
    stats_device,
)
from strawboat.util.bits import pack_bitmap, pack_block128


def test_bitunpack_matches_host():
    rng = np.random.default_rng(0)
    for b in (1, 5, 13, 16, 24, 32):
        n_blocks = 8
        vals = rng.integers(0, 1 << b if b < 32 else 1 << 32, (n_blocks, 128), dtype=np.uint64).astype(np.uint32)
        packed = b"".join(pack_block128(v, b) for v in vals)
        words = np.frombuffer(packed, np.uint32).reshape(n_blocks, b * 4)
        got = np.asarray(bitunpack_device(jnp.asarray(words), b))
        np.testing.assert_array_equal(got, vals)


def test_rle_expand():
    counts = jnp.asarray(np.array([3, 1, 4, 0, 2], np.int32))
    values = jnp.asarray(np.array([7, 8, 9, 0, 10], np.int64))
    out = np.asarray(rle_expand_device(counts, values, 10))
    np.testing.assert_array_equal(out, [7, 7, 7, 8, 9, 9, 9, 9, 10, 10])


def test_dict_freq_onevalue_validity():
    idx = jnp.asarray(np.array([0, 2, 1, 2], np.uint32))
    d = jnp.asarray(np.array([10, 20, 30], np.int64))
    np.testing.assert_array_equal(np.asarray(dict_gather_device(idx, d)), [10, 30, 20, 30])
    np.testing.assert_array_equal(np.asarray(one_value_device(jnp.int64(5), 4)), [5] * 4)
    out = freq_scatter_device(jnp.int64(9), jnp.asarray(np.array([1, 3], np.int32)), jnp.asarray(np.array([5, 6], np.int64)), 5)
    np.testing.assert_array_equal(np.asarray(out), [9, 5, 9, 6, 9])
    bools = np.random.default_rng(0).random(100) > 0.4
    packed = jnp.asarray(np.frombuffer(pack_bitmap(bools), np.uint8))
    np.testing.assert_array_equal(np.asarray(unpack_validity_device(packed, 100)), bools)


def test_stats_device_matches_host():
    rng = np.random.default_rng(2)
    vals = rng.integers(0, 50, 1000).astype(np.int64)
    mask = rng.random(1000) > 0.3
    host = gen_stats(vals, mask)
    dev = stats_device(jnp.asarray(vals), jnp.asarray(mask))
    assert int(dev["min"]) == vals.min() and int(dev["max"]) == vals.max()
    assert int(dev["null_count"]) == host.null_count
    assert int(dev["set_count"]) == host.set_count
    # run count definition matches the reference scalar loop
    run_count = 0
    last = 0
    for v, m in zip(vals, mask):
        if m and v != last:
            run_count += 1
            last = v
    assert int(dev["run_count"]) == run_count
    sorted_vals = np.sort(rng.integers(0, 10**6, 512)).astype(np.int64)
    assert bool(stats_device(jnp.asarray(sorted_vals), None)["is_sorted"])


def test_bitpacked_size_matches_encoder():
    from strawboat.codecs.integer import bitpack_encode

    rng = np.random.default_rng(3)
    vals = rng.integers(0, 1 << 15, 128 * 16, dtype=np.uint64).astype(np.uint32)
    host = len(bitpack_encode(vals))
    dev = int(bitpacked_size_bytes(jnp.asarray(vals)))
    assert host == dev
    widths = np.asarray(block_bit_widths(jnp.asarray(vals)))
    assert widths.shape == (16,)


# ---------------------------------------------------------------------------
# Resident plane unpack (exec/resident._unpack_plane_tiled): plain jnp, the
# exact inverse of the plane packers.


@pytest.mark.parametrize("b", range(33))
def test_plane_unpack_matches_host_blocks(b):
    """BitPacker4x blocks (util/bits) relaid as plane words unpack to the
    block values, slot s holding block value ``_slot_source_index[s]``."""
    from strawboat.exec.resident import (
        _slot_source_index,
        _unpack_plane_tiled,
        transpose_words_host_tiled,
    )

    tile = 512
    n_blocks = 3 * tile // 4 - 5  # 3 tiles, the last one padded
    rng = np.random.default_rng(100 + b)
    hi = 1 << b
    vals = rng.integers(0, hi, (n_blocks, 128), dtype=np.uint64).astype(np.uint32)
    if b == 0:
        wt3 = np.zeros((3, 0, tile), np.uint32)
    else:
        packed = b"".join(pack_block128(v, b) for v in vals)
        wt3 = transpose_words_host_tiled(np.frombuffer(packed, np.uint32), b, tile)
    assert wt3.shape == (3, b, tile)
    got = np.asarray(_unpack_plane_tiled(jnp.asarray(wt3), b))
    src = _slot_source_index(3, tile)
    real = src < vals.size
    np.testing.assert_array_equal(got[real], vals.reshape(-1)[src[real]])
    assert not got[~real].any()  # zero-padded lanes decode to zero


@pytest.mark.parametrize("b", [1, 2, 3, 5, 7, 8, 11, 16, 17, 24, 31, 32])
@pytest.mark.parametrize("n", [1, 777, 70_000])
def test_plane_pack_unpack_roundtrip(b, n):
    """Both packers (host below 2^16 values, device above) round-trip
    through the unpack in natural row order; the padding tail is zero."""
    from strawboat.exec.resident import (
        _pack_plane,
        _pack_plane_device,
        _slots_for,
        _unpack_plane_tiled,
    )

    tile = 512
    rng = np.random.default_rng(b * 7 + n)
    vals = rng.integers(0, 1 << b, n, dtype=np.uint64).astype(np.uint32)
    slots = _slots_for(n, tile)
    want = np.zeros(slots, np.uint32)
    want[:n] = vals
    for wt3 in (
        _pack_plane(vals, b, tile),
        _pack_plane_device(jnp.asarray(vals), b, tile),
    ):
        assert wt3.shape == (slots // (32 * tile), b, tile)
        np.testing.assert_array_equal(
            np.asarray(_unpack_plane_tiled(wt3, b)), want
        )


def test_pack_plane_device_keys_on_tile():
    """The device packer's compiled function depends on the tile width, so
    two widths in one process must each get their own layout."""
    from strawboat.exec.resident import _pack_plane_device, _unpack_plane_tiled

    vals = np.arange(70_000, dtype=np.uint32) % 1000
    for tile in (512, 1024, 512):
        wt3 = _pack_plane_device(jnp.asarray(vals), 10, tile)
        assert wt3.shape[1:] == (10, tile)
        got = np.asarray(_unpack_plane_tiled(wt3, 10))[: vals.size]
        np.testing.assert_array_equal(got, vals)
