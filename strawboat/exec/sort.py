"""ORDER BY / top-k — order-preserving u64 keys + argsort/top_k.

Comparison sorts with data-dependent branches don't vectorize; the idiom
here is: encode each sort column into an order-preserving
unsigned key, compose multi-column orders with a stable ``lexsort``, and use
``lax.top_k`` for LIMIT-k queries (O(n log k) and single-pass over device memory
instead of a full O(n log^2 n) bitonic argsort).

No reference counterpart (strawboat is a storage format); this is part of
the query layer built on top (SURVEY.md §2.8 / "beyond the reference").
"""

from __future__ import annotations

import functools
from typing import Optional, Sequence, Tuple

import jax
import jax.numpy as jnp


def orderable_u64(values: jax.Array, descending: bool = False) -> jax.Array:
    """Map values to u64 such that unsigned compare == the column's order.

    int: flip the sign bit (two's complement -> biased).
    float: IEEE total order — negative values flip all bits, positive flip
    the sign bit (NaNs sort above +inf; -NaN below -inf).
    bool/uint: zero-extend.  ``descending`` complements the key.
    """
    dt = values.dtype
    if jnp.issubdtype(dt, jnp.floating):
        nbits = dt.itemsize * 8
        u = jax.lax.bitcast_convert_type(
            values, {16: jnp.uint16, 32: jnp.uint32, 64: jnp.uint64}[nbits]
        )
        sign = u >> (nbits - 1)
        flipped = jnp.where(
            sign.astype(jnp.bool_),
            ~u,
            u | (u.dtype.type(1) << (nbits - 1)),
        )
        key = flipped.astype(jnp.uint64)
        if nbits < 64:
            key = key << (64 - nbits)
    elif dt == jnp.bool_:
        key = values.astype(jnp.uint64)
    elif jnp.issubdtype(dt, jnp.unsignedinteger):
        key = values.astype(jnp.uint64)
    elif jnp.issubdtype(dt, jnp.signedinteger):
        key = values.astype(jnp.int64)
        key = jax.lax.bitcast_convert_type(key, jnp.uint64) ^ jnp.uint64(1 << 63)
    else:
        raise TypeError(f"unorderable dtype {dt}")
    if descending:
        key = ~key
    return key


@functools.partial(jax.jit, static_argnames=("descending", "limit"))
def sort_indices(
    cols: Tuple[jax.Array, ...],
    descending: Tuple[bool, ...],
    mask: Optional[jax.Array] = None,
    limit: Optional[int] = None,
) -> jax.Array:
    """Row indices ordering by ``cols`` (first column most significant).

    Invalid rows (mask False) sort after every valid row.  Stable within
    equal keys.  With ``limit`` and a single column, uses ``lax.top_k``
    (single HBM pass) instead of a full argsort.
    """
    n = cols[0].shape[0]
    # keys in significance order (most significant first)
    keys = [orderable_u64(c, d) for c, d in zip(cols, descending)]
    if mask is not None:
        # invalid rows lose every comparison: clear their keys and add a
        # most-significant validity key (valid=0 sorts before invalid=1)
        keys = [jnp.where(mask, k, jnp.uint64(0)) for k in keys]
        keys.insert(0, (~mask).astype(jnp.uint64))
    if limit is not None and len(keys) == 1:
        # top_k returns the k largest — complement for ascending order
        _, idx = jax.lax.top_k(~keys[0], min(limit, n))
        return idx
    # lexsort sorts by its LAST key as primary → pass least-significant first
    order = jnp.lexsort(tuple(reversed(keys)))
    if limit is not None:
        order = order[: min(limit, n)]
    return order


def dictionary_rank_values(col) -> jax.Array:
    """Sortable values for a column: dictionary-coded (string) columns map
    codes → lexical rank so ORDER BY is byte-order correct even though the
    dictionary is built in first-occurrence order.

    The rank table is a host argsort of the (small) dictionary; the remap is
    one device gather over the codes.
    """
    if getattr(col, "dictionary", None) is None:
        return col.values
    import numpy as np
    import pyarrow.compute as pc

    order = pc.sort_indices(col.dictionary).to_numpy(zero_copy_only=False)
    rank = np.empty(len(col.dictionary), dtype=np.int32)
    rank[order] = np.arange(len(col.dictionary), dtype=np.int32)
    return jnp.asarray(rank)[col.values]


def sort_table(
    table,
    by: Sequence,
    mask: Optional[jax.Array] = None,
    limit: Optional[int] = None,
):
    """Order a DeviceTable; returns (row_indices, taken_valid_mask).

    ``by`` items are column names or ``(name, "desc"|"asc")`` pairs.  String
    (dictionary-coded) columns order lexically (codes are remapped through a
    rank table derived from the sorted dictionary).
    """
    names, desc = [], []
    for item in by:
        if isinstance(item, tuple):
            names.append(item[0])
            desc.append(str(item[1]).lower().startswith("desc"))
        else:
            names.append(item)
            desc.append(False)
    cols = tuple(dictionary_rank_values(table[n]) for n in names)
    row_mask = mask
    for n in names:
        v = table[n].validity
        if v is not None:
            row_mask = v if row_mask is None else (row_mask & v)
    idx = sort_indices(cols, tuple(desc), row_mask, limit)
    taken_valid = None if row_mask is None else row_mask[idx]
    return idx, taken_valid


def take_table(table, indices: jax.Array):
    """Materialize a row gather as a new DeviceTable (same column kinds)."""
    from ..errors import NotYetImplementedError
    from .scan import DeviceColumn, DeviceTable

    out = {}
    for name, c in table.columns.items():
        if getattr(c, "offsets", None) is not None:
            raise NotYetImplementedError(
                f"row gather over flattened list column {name!r}; project it "
                "out with select() before ORDER BY / LIMIT"
            )
        out[name] = DeviceColumn(
            name=name,
            dtype=c.dtype,
            values=c.values[indices],
            validity=None if c.validity is None else c.validity[indices],
            dictionary=c.dictionary,
        )
    return DeviceTable(columns=out, num_rows=int(indices.shape[0]))
