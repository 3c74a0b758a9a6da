"""Distributed equi-join: co-shuffle both sides by key hash, join locally.

The radix-partitioned hash join (BASELINE north-star operator):
both tables repartition with the same key hash (one all_to_all each), so
matching keys land on the same shard; each shard then runs the vectorized
sort + searchsorted join on its local partitions.  Join outputs stay sharded
for downstream aggregation.
"""

from __future__ import annotations

import functools
from typing import Tuple

import jax
import jax.numpy as jnp
from jax import shard_map
from jax.sharding import Mesh, PartitionSpec as P

from ..exec.join import _join_indices
from .shuffle import build_send_bins, hash_partition_ids


@functools.lru_cache(maxsize=None)
def _build(
    mesh: Mesh,
    axis: str,
    n_probe_payloads: int,
    n_build_payloads: int,
    probe_capacity: int,
    build_capacity: int,
    max_fanout: int,
):
    n_parts = mesh.shape[axis]

    def shard_fn(pk, p_payloads, p_valid, bk, b_payloads, b_valid):
        # co-shuffle by key hash
        def exchange(key, payloads, valid, capacity):
            part = hash_partition_ids(key, n_parts)
            # invalid rows to a bin that still exchanges but is masked
            bins, bvalid, counts = build_send_bins(
                part, (key,) + tuple(payloads) + (valid,), n_parts, capacity
            )
            ex = [
                jax.lax.all_to_all(b, axis, split_axis=0, concat_axis=0, tiled=True)
                for b in bins
            ]
            bx = jax.lax.all_to_all(
                bvalid, axis, split_axis=0, concat_axis=0, tiled=True
            )
            k2 = ex[0].reshape(-1)
            outs = tuple(e.reshape(-1) for e in ex[1:-1])
            v2 = bx.reshape(-1) & ex[-1].reshape(-1)
            return k2, outs, v2, jnp.max(counts).astype(jnp.int32)

        pk2, p_out, pv2, pneed = exchange(pk, p_payloads, p_valid, probe_capacity)
        bk2, b_out, bv2, bneed = exchange(bk, b_payloads, b_valid, build_capacity)
        # local join: invalid build rows mask out of the match set directly
        # (no sentinel value a legitimate key could collide with)
        pi, bi, jvalid, max_run = _join_indices(bk2, pk2, max_fanout, bv2)
        jvalid = jnp.logical_and(jvalid, jnp.repeat(pv2, max_fanout))
        out_p = tuple(c[pi] for c in p_out)
        out_b = tuple(c[bi] for c in b_out)
        # per-shard capacity demands (bin sizes + fan-out) for overflow retry
        required = jnp.stack([pneed, bneed, max_run]).reshape(1, 3)
        return pk2[pi], out_p, out_b, jvalid, required

    pspec = tuple(P(axis) for _ in range(n_probe_payloads))
    bspec = tuple(P(axis) for _ in range(n_build_payloads))
    fn = shard_map(
        shard_fn,
        mesh=mesh,
        in_specs=(P(axis), pspec, P(axis), P(axis), bspec, P(axis)),
        out_specs=(P(axis), pspec, bspec, P(axis), P(axis)),
        check_vma=False,
    )
    return jax.jit(fn)


def distributed_join(
    mesh: Mesh,
    axis: str,
    probe_key: jax.Array,
    probe_payloads: Tuple[jax.Array, ...],
    build_key: jax.Array,
    build_payloads: Tuple[jax.Array, ...],
    probe_valid=None,
    build_valid=None,
    capacity_per_shard: int = 0,
    max_fanout: int = 1,
    on_overflow: str = "grow",
):
    """Inner equi-join of two sharded tables.

    Returns (key, probe_payloads', build_payloads', valid) — sharded join
    output rows (n_parts * capacity * max_fanout per shard).
    ``capacity_per_shard`` bounds rows landing on one shard per source shard
    (default: local rows / n_parts * 2 slack).  Bin or fan-out overflow is
    detected on device and retried with grown capacities (default) or raised
    as :class:`CapacityError` — never silent row loss.
    """
    from ..errors import CapacityError

    n_parts = mesh.shape[axis]
    n_probe = probe_key.shape[0]
    n_build = build_key.shape[0]
    pcap = capacity_per_shard or max((n_probe // n_parts // n_parts) * 2, 64)
    bcap = capacity_per_shard or max((n_build // n_parts // n_parts) * 2, 64)
    if probe_valid is None:
        probe_valid = jnp.ones(n_probe, dtype=jnp.bool_)
    if build_valid is None:
        build_valid = jnp.ones(n_build, dtype=jnp.bool_)
    fanout = max_fanout
    while True:
        fn = _build(
            mesh, axis, len(probe_payloads), len(build_payloads), pcap, bcap, fanout
        )
        key, p_out, b_out, valid, required = fn(
            probe_key, tuple(probe_payloads), probe_valid,
            build_key, tuple(build_payloads), build_valid,
        )
        req = jax.device_get(jnp.max(required, axis=0))
        pneed, bneed, frun = int(req[0]), int(req[1]), int(req[2])
        if pneed <= pcap and bneed <= bcap and frun <= fanout:
            return key, p_out, b_out, valid
        if on_overflow == "raise":
            if pneed > pcap:
                raise CapacityError("join probe shuffle bin", pcap, pneed)
            if bneed > bcap:
                raise CapacityError("join build shuffle bin", bcap, bneed)
            raise CapacityError("join fan-out", fanout, frun)
        if pneed > pcap:
            pcap = 1 << (pneed - 1).bit_length()
        if bneed > bcap:
            bcap = 1 << (bneed - 1).bit_length()
        if frun > fanout:
            fanout = 1 << (frun - 1).bit_length()
