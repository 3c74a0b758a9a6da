"""Distributed shuffle: keyed repartition over the mesh via all_to_all.

The engine's NCCL/UCX-style exchange (SURVEY §2.8; XLA lowers the
all_to_all to NCCL on GPUs): rows are bucketed
by ``hash(key) % P`` into fixed-capacity per-destination bins (static shapes —
XLA requirement), exchanged with ``jax.lax.all_to_all`` inside ``shard_map``,
and masked on arrival.  Skew handling: optional key salting spreads a hot key
over ``salt`` destination buckets; aggregation-side must then re-combine,
which ``distributed_aggregate`` does by a second keyed exchange.
"""

from __future__ import annotations

import functools
from typing import Optional, Tuple

import jax
import jax.numpy as jnp
from jax import shard_map
from jax.sharding import Mesh, PartitionSpec as P


def _mix64(x: jax.Array) -> jax.Array:
    """splitmix64 finalizer — cheap, well-distributed device hash."""
    x = x.astype(jnp.uint64)
    x = (x ^ (x >> 30)) * jnp.uint64(0xBF58476D1CE4E5B9)
    x = (x ^ (x >> 27)) * jnp.uint64(0x94D049BB133111EB)
    return x ^ (x >> 31)


def hash_partition_ids(
    key: jax.Array, n_parts: int, salt: int = 0, salt_key: Optional[jax.Array] = None
) -> jax.Array:
    """Destination shard per row; ``salt>0`` spreads each key over ``salt``
    buckets using a per-row salt stream (skew-aware repartitioning)."""
    h = _mix64(key)
    if salt > 0:
        s = (
            salt_key
            if salt_key is not None
            else jnp.arange(key.shape[0], dtype=jnp.uint64)
        )
        h = h + (s % jnp.uint64(salt))
    return (h % jnp.uint64(n_parts)).astype(jnp.int32)


def build_send_bins(
    part_ids: jax.Array, payloads: Tuple[jax.Array, ...], n_parts: int, capacity: int
):
    """Pack rows into (n_parts, capacity) bins + per-bin counts.

    Rows beyond a bin's capacity are dropped (caller sizes capacity with
    slack; counts report the true totals so overflow is detectable).
    """
    n = part_ids.shape[0]
    order = jnp.argsort(part_ids)
    sorted_parts = part_ids[order]
    # slot within each destination bin = running index - first index of part
    first_idx = jnp.searchsorted(sorted_parts, jnp.arange(n_parts, dtype=part_ids.dtype))
    slot = jnp.arange(n) - first_idx[sorted_parts]
    counts = jnp.bincount(part_ids, length=n_parts)
    ok = slot < capacity
    slot_c = jnp.where(ok, slot, capacity - 1)
    bins = []
    for p in payloads:
        buf = jnp.zeros((n_parts, capacity), dtype=p.dtype)
        buf = buf.at[sorted_parts, slot_c].set(jnp.where(ok, p[order], buf[sorted_parts, slot_c]))
        bins.append(buf)
    valid = jnp.zeros((n_parts, capacity), dtype=jnp.bool_)
    valid = valid.at[sorted_parts, slot_c].set(ok)
    return bins, valid, counts


@functools.lru_cache(maxsize=None)
def _build_shuffle(mesh: Mesh, axis: str, n_payloads: int, cap: int, salt: int):
    """One jitted exchange per (mesh, payload count, capacity, salt): built
    once and reused, so repeated shuffles do not trace and compile again."""
    n_parts = mesh.shape[axis]

    @functools.partial(
        shard_map,
        mesh=mesh,
        in_specs=(P(axis), tuple(P(axis) for _ in range(n_payloads))),
        out_specs=(
            P(axis),
            tuple(P(axis) for _ in range(n_payloads)),
            P(axis),
            P(axis),
        ),
        check_vma=False,
    )
    def _shuffle(local_key, local_payloads):
        part = hash_partition_ids(local_key, n_parts, salt=salt)
        bins, valid, counts = build_send_bins(
            part, (local_key,) + tuple(local_payloads), n_parts, cap
        )
        exchanged = [
            jax.lax.all_to_all(b, axis, split_axis=0, concat_axis=0, tiled=True)
            for b in bins
        ]
        valid_x = jax.lax.all_to_all(
            valid, axis, split_axis=0, concat_axis=0, tiled=True
        )
        out_key = exchanged[0].reshape(-1)
        outs = tuple(e.reshape(-1) for e in exchanged[1:])
        max_count = jnp.max(counts).reshape(1).astype(jnp.int32)
        return out_key, outs, valid_x.reshape(-1), max_count

    return jax.jit(_shuffle)


def shuffle_by_key(
    mesh: Mesh,
    axis: str,
    key: jax.Array,
    payloads: Tuple[jax.Array, ...],
    capacity: int,
    salt: int = 0,
    on_overflow: str = "grow",
):
    """All-to-all repartition rows by key hash across ``axis``.

    Inputs are sharded along ``axis`` on dim 0.  Returns (key', payloads',
    valid') re-sharded so equal keys land on the same shard, flattened to
    (P * capacity) rows per shard.

    A bin overflow (more rows hash to one destination than ``capacity``)
    never passes silently: ``on_overflow="grow"`` (default) doubles capacity
    and re-runs; ``"raise"`` raises :class:`CapacityError` carrying the
    required capacity.
    """
    from ..errors import CapacityError

    cap = capacity
    while True:
        out_key, outs, valid, max_counts = _build_shuffle(
            mesh, axis, len(payloads), cap, salt
        )(key, tuple(payloads))
        required = int(jax.device_get(jnp.max(max_counts)))
        if required <= cap:
            return out_key, outs, valid
        if on_overflow == "raise":
            raise CapacityError("shuffle bin", cap, required)
        # grow to the next power of two covering the true max bin size
        cap = 1 << (required - 1).bit_length()
