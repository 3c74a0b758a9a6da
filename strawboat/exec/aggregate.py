"""Hash/group aggregation — sort + segment reduce.

A pointer-chasing hashmap is a poor fit for a vectorized device; the
grouping idiom here is:
hash keys → sort by hash → segment boundaries via neighbor-compare →
``jax.ops.segment_*`` with a static group capacity.  All stages are jnp, so
they fuse under an outer jit with the scan/filter stages.
"""

from __future__ import annotations

import functools
from typing import Dict, Optional, Sequence, Tuple

import jax
import jax.numpy as jnp

_AGG_FNS = {
    "sum": jax.ops.segment_sum,
    "min": jax.ops.segment_min,
    "max": jax.ops.segment_max,
}


def _col_u64(c: jax.Array) -> jax.Array:
    """Bijective 64-bit image of one key column (equality-preserving).

    Ints/bools map via two's-complement wrap; floats map via bitcast (never
    value truncation) — so two rows share an image iff their stored key bits
    are equal.  Grouping on images is therefore *exact* per column."""
    if jnp.issubdtype(c.dtype, jnp.floating):
        if c.dtype == jnp.float64:
            return jax.lax.bitcast_convert_type(c, jnp.uint64)
        return jax.lax.bitcast_convert_type(
            c.astype(jnp.float32), jnp.uint32
        ).astype(jnp.uint64)
    return c.astype(jnp.uint64)


def _key_u64(cols: Sequence[jax.Array]) -> jax.Array:
    """One 64-bit *reporting* key (identity for a single int key; hashed mix
    otherwise).  Grouping itself never relies on this — see
    :func:`grouped_aggregate`'s lexicographic sort — so a mixing collision
    can never merge groups; it only makes two report keys look alike."""
    k = _col_u64(cols[0])
    if len(cols) == 1:
        return k
    acc = k
    for c in cols[1:]:
        c = _col_u64(c)
        acc = acc * jnp.uint64(0x9E3779B97F4A7C15) + c + jnp.uint64(0x85EBCA6B)
    return acc


@functools.partial(jax.jit, static_argnames=("num_groups", "agg_specs"))
def grouped_aggregate(
    key_cols: Tuple[jax.Array, ...],
    value_cols: Tuple[jax.Array, ...],
    mask: Optional[jax.Array],
    num_groups: int,
    agg_specs: Tuple[Tuple[str, int], ...],  # (fn_name, value_col_index)
):
    """Group rows by composite key; returns (unique_keys, n_groups, aggs...).

    Grouping is **exact** for any number of key columns: rows sort
    lexicographically over the per-column 64-bit images (``lax.sort`` with
    ``num_keys`` = all key columns), so two rows share a group iff every key
    column matches — no hashed-combination collisions (the round-2 silent
    -wrong-answer class).  The returned ``unique_keys`` u64 is a *label*
    (mixed hash for composites), not the grouping basis.

    Capacity ``num_groups`` is static; overflow groups collapse into the last
    slot (caller sizes capacity from planning stats / zone maps).
    """
    imgs = [_col_u64(c) for c in key_cols]
    n = imgs[0].shape[0]
    sort_keys = list(imgs)
    if mask is not None:
        # masked-out rows sort to the end (primary key: 0 valid / 1 masked)
        sort_keys = [jnp.where(mask, 0, 1).astype(jnp.uint8)] + sort_keys
    row_ids = jnp.arange(n, dtype=jnp.int32)
    sorted_ops = jax.lax.sort(
        tuple(sort_keys) + (row_ids,), num_keys=len(sort_keys)
    )
    order = sorted_ops[-1]
    simgs = sorted_ops[1:-1] if mask is not None else sorted_ops[:-1]
    key = _key_u64(key_cols)
    skey = key[order]
    diff = jnp.zeros((max(n - 1, 0),), jnp.bool_)
    for si in simgs:
        diff = diff | (si[1:] != si[:-1])
    new_seg = jnp.concatenate(
        [jnp.ones((1,), jnp.int32), diff.astype(jnp.int32)]
    )
    if mask is not None:
        valid_sorted = mask[order]
        new_seg = jnp.where(valid_sorted, new_seg, 0)
    seg_ids = jnp.cumsum(new_seg) - 1
    seg_ids = jnp.clip(seg_ids, 0, num_groups - 1)
    if mask is not None:
        seg_ids = jnp.where(mask[order], seg_ids, num_groups - 1)
    outs = []
    for fn_name, vi in agg_specs:
        v = value_cols[vi][order]
        if fn_name == "sum" and jnp.issubdtype(v.dtype, jnp.integer) and v.dtype.itemsize < 8:
            # SQL SUM is wide: int32 inputs (e.g. decoded resident columns)
            # must not accumulate in int32
            v = v.astype(jnp.int64)
        if fn_name == "count":
            ones = jnp.ones_like(v, dtype=jnp.int64)
            if mask is not None:
                ones = jnp.where(mask[order], ones, 0)
            outs.append(jax.ops.segment_sum(ones, seg_ids, num_segments=num_groups))
            continue
        if mask is not None:
            # Masked rows land in segment num_groups-1, which is a REAL group
            # whenever the group count exactly fills capacity — so every agg
            # must neutralize masked values, not just sum (silent-wrong-answer
            # edge otherwise: min/max of the last group absorbing filtered rows).
            if fn_name == "sum":
                v = jnp.where(mask[order], v, 0)
            elif fn_name == "min":
                neutral = (
                    jnp.asarray(jnp.inf, v.dtype)
                    if jnp.issubdtype(v.dtype, jnp.floating)
                    else jnp.iinfo(v.dtype).max
                )
                v = jnp.where(mask[order], v, neutral)
            elif fn_name == "max":
                neutral = (
                    jnp.asarray(-jnp.inf, v.dtype)
                    if jnp.issubdtype(v.dtype, jnp.floating)
                    else jnp.iinfo(v.dtype).min
                )
                v = jnp.where(mask[order], v, neutral)
        outs.append(_AGG_FNS[fn_name](v, seg_ids, num_segments=num_groups))
    first_idx = jnp.cumsum(new_seg) - 1
    first_idx = jnp.clip(first_idx, 0, num_groups - 1)
    if mask is not None:
        # masked rows must not clobber the last real group's key slot
        first_idx = jnp.where(mask[order], first_idx, num_groups - 1)
        skey_w = jnp.where(mask[order], skey, jnp.uint64(0))
    else:
        skey_w = skey
    uniq_keys = jnp.zeros((num_groups,), jnp.uint64).at[first_idx].max(skey_w)
    n_groups = jnp.sum(new_seg)
    # per-group representative row (for key column reconstruction)
    rep_rows = jnp.zeros((num_groups,), jnp.int32).at[
        jnp.clip(seg_ids, 0, num_groups - 1)
    ].max(order.astype(jnp.int32))
    return uniq_keys, n_groups, rep_rows, tuple(outs)


def hash_aggregate(
    table,
    keys: Sequence[str],
    aggs: Dict[str, Tuple[str, str]],
    num_groups: int = 65536,
    mask: Optional[jax.Array] = None,
    on_overflow: str = "grow",
):
    """Group-by aggregate over a DeviceTable.

    aggs: out_name -> (fn, column);  fn in {sum, min, max, count, avg};
    column may be a name or an Expr (computed aggregate input, e.g.
    ``col("price") * (100 - col("disc"))``).
    Returns dict with 'keys' (u64 composite), 'n_groups', per-agg arrays, and
    'rep_rows' (a representative source row per group, for key readback).
    More distinct keys than ``num_groups`` never pass silently:
    ``on_overflow="grow"`` (default) doubles the capacity and re-runs,
    ``"raise"`` raises :class:`CapacityError`.
    """
    key_cols = tuple(table[k].values for k in keys)
    # avg lowers to sum/count over the same sorted pass
    lowered: Dict[str, Tuple[str, str]] = {}
    avg_names = []
    for name, (fn, c) in aggs.items():
        if fn in ("avg", "mean"):
            lowered[f"__{name}_sum"] = ("sum", c)
            lowered[f"__{name}_cnt"] = ("count", c)
            avg_names.append(name)
        else:
            lowered[name] = (fn, c)

    def _values(fn, c):
        from .expr import Expr
        from ..errors import NotYetImplementedError

        if isinstance(c, Expr):
            v, m = c.fn(table)
            if m is not None:
                if fn != "sum":
                    raise NotYetImplementedError(
                        f"{fn} over a nullable expression; filter nulls first"
                    )
                v = jnp.where(m, v, 0)  # SQL SUM ignores null inputs
            return v
        return table[c].values

    value_inputs = list(lowered.values())
    value_cols = tuple(_values(fn, c) for (fn, c) in value_inputs)
    agg_specs = tuple(
        (fn, i) for i, (fn, _c) in enumerate(value_inputs)
    )
    from ..errors import CapacityError

    cap = num_groups
    while True:
        uniq, n_groups, rep_rows, outs = grouped_aggregate(
            key_cols, value_cols, mask, cap, agg_specs
        )
        need = int(jax.device_get(n_groups))
        if need <= cap:
            break
        if on_overflow == "raise":
            raise CapacityError("aggregate groups", cap, need)
        cap = 1 << (need - 1).bit_length()
    result = {"keys": uniq, "n_groups": n_groups, "rep_rows": rep_rows}
    # decoded per-key columns via each group's representative source row
    safe_rep = jnp.clip(rep_rows, 0, max(len(table[keys[0]]) - 1, 0))
    for k in keys:
        result[f"key_{k}"] = table[k].values[safe_rep]
    for name, o in zip(lowered.keys(), outs):
        result[name] = o
    for name in avg_names:
        s = result.pop(f"__{name}_sum")
        c = result.pop(f"__{name}_cnt")
        ftype = s.dtype if jnp.issubdtype(s.dtype, jnp.floating) else jnp.float64
        result[name] = s.astype(ftype) / jnp.maximum(c, 1).astype(ftype)
    return result


@functools.partial(jax.jit, static_argnames=("num_groups", "chunk"))
def dense_group_sum(
    codes: jax.Array,
    values: jax.Array,
    num_groups: int,
    mask: Optional[jax.Array] = None,
    chunk: int = 1 << 15,
):
    """Exact int64 per-group sums for dense small-int keys — as matmuls.

    For dense codes (dict/string codes, flag columns, composite small keys)
    the grouped sum is a one-hot matmul: split values into 8-bit planes, accumulate
    ``one_hot(codes)ᵀ @ plane`` per chunk in f32 (exact: ≤ 2^15 terms × 2^8
    < 2^24, and 0/1 and 8-bit operands are exact in TF32 too), recombine
    planes with int64 shifts.  Also returns per-group counts.  Negative /
    out-of-range codes are dropped.  This stands in for ``segment_sum``,
    which the first accelerator serialized; whether it still pays on the
    H100 is ROADMAP D4 (``chip_smoke.py`` times both).
    """
    n = codes.shape[0]
    pad = (-n) % chunk
    if pad:
        codes = jnp.concatenate([codes, jnp.full(pad, -1, codes.dtype)])
        values = jnp.concatenate([values, jnp.zeros(pad, values.dtype)])
        if mask is not None:
            mask = jnp.concatenate([mask, jnp.zeros(pad, jnp.bool_)])
    if mask is not None:
        codes = jnp.where(mask, codes, -1)
    valid = (codes >= 0) & (codes < num_groups)
    v = jnp.where(valid, values, 0).astype(jnp.int64)
    # two's-complement bit planes: per-plane sums recombined with wrapping
    # u64 arithmetic give Σv mod 2^64 — the exact int64 sum when it fits
    vb = jax.lax.bitcast_convert_type(v, jnp.uint64)
    n_chunks = (n + pad) // chunk
    codes_c = codes.reshape(n_chunks, chunk)
    valid_c = valid.reshape(n_chunks, chunk)
    vb_c = vb.reshape(n_chunks, chunk)
    iota = jnp.arange(num_groups, dtype=codes.dtype)

    def body(carry, inp):
        acc, cnt = carry
        c, val_mask, vbk = inp
        # 8-bit planes computed in-chunk (fused; never materialized at size n)
        pl8 = jnp.stack(
            [
                ((vbk >> jnp.uint64(8 * p)) & jnp.uint64(0xFF)).astype(jnp.float32)
                for p in range(8)
            ],
            axis=0,
        )
        onehot = (c[:, None] == iota[None, :]).astype(jnp.float32)
        # (8, chunk) @ (chunk, G) matmul
        part = jax.lax.dot_general(
            pl8,
            onehot,
            (((1,), (0,)), ((), ())),
            preferred_element_type=jnp.float32,
        )
        cnt_part = jnp.sum(
            jnp.where(val_mask[:, None], onehot, 0.0), axis=0
        )
        return (acc + part.astype(jnp.uint64), cnt + cnt_part.astype(jnp.int64)), None

    (acc, cnt), _ = jax.lax.scan(
        body,
        (
            jnp.zeros((8, num_groups), jnp.uint64),
            jnp.zeros((num_groups,), jnp.int64),
        ),
        (codes_c, valid_c, vb_c),
    )
    shifts = jnp.uint64(1) << (jnp.uint64(8) * jnp.arange(8, dtype=jnp.uint64))
    sums_u = jnp.sum(acc * shifts[:, None], axis=0, dtype=jnp.uint64)
    sums = jax.lax.bitcast_convert_type(sums_u, jnp.int64)
    return sums, cnt


@functools.partial(jax.jit, static_argnames=("num_segments",))
def list_segment_sum(
    values: jax.Array, offsets: jax.Array, num_segments: int
) -> jax.Array:
    """Per-row sum over a flattened list column (offsets from DeviceListColumn)."""
    n_vals = values.shape[0]
    # segment id per flattened value: count of offsets <= position - 1
    pos = jnp.arange(n_vals)
    seg = jnp.searchsorted(offsets[1:], pos, side="right")
    return jax.ops.segment_sum(values, seg, num_segments=num_segments)


@functools.partial(jax.jit, static_argnames=("fn",))
def scalar_aggregate(values: jax.Array, mask: Optional[jax.Array], fn: str):
    """Ungrouped aggregate with validity/selection mask."""
    if fn == "count":
        if mask is None:
            return jnp.asarray(values.shape[0], jnp.int64)
        return jnp.sum(mask.astype(jnp.int64))
    if fn == "sum" and jnp.issubdtype(values.dtype, jnp.integer) and values.dtype.itemsize < 8:
        values = values.astype(jnp.int64)  # SQL SUM is wide
    if mask is not None:
        if fn == "sum":
            values = jnp.where(mask, values, 0)
        elif fn == "min":
            values = jnp.where(mask, values, jnp.iinfo(values.dtype).max if values.dtype.kind == "i" else jnp.inf)
        elif fn == "max":
            values = jnp.where(mask, values, jnp.iinfo(values.dtype).min if values.dtype.kind == "i" else -jnp.inf)
    if fn == "sum":
        return jnp.sum(values)
    if fn == "min":
        return jnp.min(values)
    if fn == "max":
        return jnp.max(values)
    if fn in ("mean", "avg"):
        if mask is None:
            return jnp.mean(values)
        s = jnp.sum(jnp.where(mask, values, 0))
        c = jnp.sum(mask.astype(values.dtype))
        return s / c
    raise ValueError(f"unknown aggregate {fn}")
