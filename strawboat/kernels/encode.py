"""Device-side encoder support: page stats + block bit-widths as reductions.

SURVEY §7 step 3: the writer's hot loops are (1) stats over the page and
(2) trial compression.  Both reduce to data-parallel reductions that run on
device when the column is already device-resident (e.g. re-encoding after a
shuffle): min/max/null-count, run counts via neighbor compares, per-block
OR-reduce bit widths for bitpacking sizing.
"""

from __future__ import annotations

from typing import Optional

import jax
import jax.numpy as jnp


def _mask_sentinels(dtype):
    """(max, min) fill values so masked slots never win a min/max reduce."""
    if jnp.issubdtype(dtype, jnp.floating):
        return jnp.array(jnp.inf, dtype), jnp.array(-jnp.inf, dtype)
    info = jnp.iinfo(dtype)
    return jnp.array(info.max, dtype), jnp.array(info.min, dtype)


@jax.jit
def stats_device(values: jax.Array, validity: Optional[jax.Array] = None):
    """Returns dict of the FamilyStats scalars the codec chooser needs."""
    n = values.shape[0]
    if validity is None:
        valid = jnp.ones((n,), jnp.bool_)
    else:
        valid = validity
    hi, lo = _mask_sentinels(values.dtype)
    vmin = jnp.min(jnp.where(valid, values, hi))
    vmax = jnp.max(jnp.where(valid, values, lo))
    null_count = n - jnp.sum(valid.astype(jnp.int32))
    # run/sortedness over valid values, seeded with 0 (reference semantics)
    prev_val = jnp.concatenate([jnp.zeros((1,), values.dtype), values[:-1]])
    # carry last valid value forward: approximate with direct neighbor when
    # dense; exact computation uses segment trick
    idx = jnp.arange(n)
    last_valid_idx = jnp.maximum.accumulate(jnp.where(valid, idx, -1))
    prev_valid_idx = jnp.concatenate([jnp.full((1,), -1), last_valid_idx[:-1]])
    prev_valid_val = jnp.where(
        prev_valid_idx >= 0, values[jnp.clip(prev_valid_idx, 0, n - 1)], 0
    )
    changed = valid & (values != prev_valid_val)
    run_count = jnp.sum(changed.astype(jnp.int32))
    descending = valid & (values < prev_valid_val)
    is_sorted = jnp.sum(descending.astype(jnp.int32)) == 0
    return {
        "min": vmin,
        "max": vmax,
        "null_count": null_count,
        "run_count": run_count,
        "is_sorted": is_sorted,
        "set_count": n - null_count,
    }


@jax.jit
def block_bit_widths(values_u32: jax.Array) -> jax.Array:
    """Per-128-block bit width (OR-reduce + bit length), for bitpack sizing.

    values_u32: (n_blocks * 128,) uint32 → (n_blocks,) int32 widths.
    """
    blocks = values_u32.reshape(-1, 128)
    acc = jax.lax.reduce_or(blocks, axes=(1,))
    # bit length of acc: 32 - clz
    clz = jnp.where(acc == 0, jnp.int32(32), jax.lax.clz(acc).astype(jnp.int32))
    return jnp.int32(32) - clz


@jax.jit
def bitpacked_size_bytes(values_u32: jax.Array) -> jax.Array:
    """Exact encoded size of a bitpacked page (header byte + 16b per block)."""
    widths = block_bit_widths(values_u32)
    return jnp.sum(widths * 16 + 1)


from functools import partial


@partial(jax.jit, static_argnums=(2,))
def paged_stats_device(
    values: jax.Array, validity: Optional[jax.Array], page_size: int
):
    """Per-page FamilyStats scalars for a whole column in ONE device call.

    The writer's hot loop 1 (reference integer/mod.rs:179-229, a per-page
    host scan + hashmap) becomes a reshape to (n_pages, page_size) and
    masked row reductions.  The tail page
    pads with invalid slots.  Returns a dict of (n_pages,) arrays:
    min/max/null_count/run_count/is_sorted/set_count/unique_est.
    """
    n = values.shape[0]
    n_pages = -(-n // page_size)
    pad = n_pages * page_size - n
    valid = (
        jnp.ones((n,), jnp.bool_) if validity is None else validity
    )
    v = jnp.pad(values, (0, pad))
    m = jnp.pad(valid, (0, pad)).reshape(n_pages, page_size)
    v = v.reshape(n_pages, page_size)
    hi, lo = _mask_sentinels(values.dtype)
    vmin = jnp.min(jnp.where(m, v, hi), axis=1)
    vmax = jnp.max(jnp.where(m, v, lo), axis=1)
    null_count = page_size - jnp.sum(m, axis=1) - (
        jnp.arange(n_pages) == n_pages - 1
    ) * pad
    set_count = jnp.sum(m, axis=1) - 0  # pad slots are invalid already
    # run/sortedness per page over valid values, seed 0 (reference semantics)
    idx = jnp.arange(page_size)[None, :]
    last_valid = jnp.maximum.accumulate(jnp.where(m, idx, -1), axis=1)
    prev_idx = jnp.concatenate(
        [jnp.full((n_pages, 1), -1), last_valid[:, :-1]], axis=1
    )
    prev_val = jnp.take_along_axis(v, jnp.clip(prev_idx, 0, page_size - 1), 1)
    prev_val = jnp.where(prev_idx >= 0, prev_val, jnp.zeros((), v.dtype))
    changed = m & (v != prev_val)
    run_count = jnp.sum(changed, axis=1)
    descending = m & (v < prev_val)
    is_sorted = jnp.sum(descending, axis=1) == 0
    # distinct estimate per page: hashed bucket occupancy (linear counting)
    B = 1024
    if jnp.issubdtype(v.dtype, jnp.floating):
        bits = jax.lax.bitcast_convert_type(
            v, jnp.uint32 if v.dtype.itemsize == 4 else jnp.uint64
        )
        h = bits.astype(jnp.uint64)
    else:
        h = v.astype(jnp.uint64)
    h = (h ^ (h >> 30)) * jnp.uint64(0xBF58476D1CE4E5B9)
    h = (h ^ (h >> 27)) * jnp.uint64(0x94D049BB133111EB)
    h = h ^ (h >> 31)
    bucket = (h % jnp.uint64(B)).astype(jnp.int32)
    page_idx = jnp.broadcast_to(jnp.arange(n_pages)[:, None], bucket.shape)
    occ = (
        jnp.zeros((n_pages, B), jnp.int32)
        .at[page_idx, bucket]
        .max(m.astype(jnp.int32))
    )
    occupied = jnp.sum(occ, axis=1).astype(jnp.float32)
    frac = jnp.clip((B - occupied) / B, 1e-9, 1.0)
    unique_est = (-B * jnp.log(frac)).astype(jnp.int32)
    return {
        "min": vmin,
        "max": vmax,
        "null_count": null_count,
        "run_count": run_count,
        "is_sorted": is_sorted,
        "set_count": set_count,
        "unique_est": unique_est,
    }


@partial(jax.jit, static_argnums=(2,))
def paged_bool_stats_device(
    values: jax.Array, validity: Optional[jax.Array], page_size: int
):
    """Boolean writer path: pack the column into LSB-first bitmap bytes ON
    DEVICE (an 8× smaller device→host download than fetching bools) plus the
    per-page counts the codec chooser needs.

    ``page_size`` must be a multiple of 8 (pages then start on byte
    boundaries of the packed stream; the device writer falls back to the
    host encoder otherwise).  Returns (packed_u8, stats_dict) where
    stats_dict holds (n_pages,) arrays true_count/set_count/run_count/
    null_count.  run_count is the exact RLE run count (nulls merge into the
    current run — reference boolean/rle.rs:31-55 semantics).
    """
    n = values.shape[0]
    n_pages = -(-n // page_size)
    pad = n_pages * page_size - n
    valid = jnp.ones((n,), jnp.bool_) if validity is None else validity
    v = jnp.pad(values, (0, pad))
    m = jnp.pad(valid, (0, pad))
    vm = v.reshape(n_pages, page_size)
    mm = m.reshape(n_pages, page_size)
    true_count = jnp.sum(vm & mm, axis=1)
    set_count = jnp.sum(mm, axis=1)
    null_count = (
        page_size
        - set_count
        - (jnp.arange(n_pages) == n_pages - 1) * pad
    )
    idx = jnp.arange(page_size)[None, :]
    last_valid = jnp.maximum.accumulate(jnp.where(mm, idx, -1), axis=1)
    prev_idx = jnp.concatenate(
        [jnp.full((n_pages, 1), -1), last_valid[:, :-1]], axis=1
    )
    prev_val = jnp.take_along_axis(vm, jnp.clip(prev_idx, 0, page_size - 1), 1)
    started = prev_idx >= 0
    changed = mm & ((vm != prev_val) | ~started)
    run_count = jnp.sum(changed, axis=1)
    # LSB-first bit pack (np.packbits(bitorder="little") layout)
    vb = v.astype(jnp.int32).reshape(-1, 8)
    weights = (jnp.int32(1) << jnp.arange(8, dtype=jnp.int32))[None, :]
    packed = jnp.sum(vb * weights, axis=1).astype(jnp.uint8)
    return packed, {
        "true_count": true_count,
        "set_count": set_count,
        "run_count": run_count,
        "null_count": null_count,
    }


@jax.jit
def distinct_estimate(values: jax.Array, num_buckets: int = 4096) -> jax.Array:
    """HyperLogLog-lite distinct estimate via hashed bucket occupancy."""
    h = values.astype(jnp.uint64)
    h = (h ^ (h >> 30)) * jnp.uint64(0xBF58476D1CE4E5B9)
    h = (h ^ (h >> 27)) * jnp.uint64(0x94D049BB133111EB)
    h = h ^ (h >> 31)
    buckets = (h % jnp.uint64(num_buckets)).astype(jnp.int32)
    occ = jnp.zeros((num_buckets,), jnp.int32).at[buckets].max(1)
    m = jnp.float32(num_buckets)
    occupied = jnp.sum(occ).astype(jnp.float32)
    # linear counting estimator
    frac = jnp.clip((m - occupied) / m, 1e-9, 1.0)
    return (-m * jnp.log(frac)).astype(jnp.int32)
