"""Chunked pipelined distributed aggregation (collective-overlap).

SURVEY §2.8's "collective-overlap" component: the table streams through in
chunks; each chunk's local partial aggregate + keyed all_to_all exchange is
dispatched asynchronously, so chunk i+1's decode/aggregate compute overlaps
chunk i's exchange in the device pipeline (single-controller JAX dispatches
are async; independent chunk computations interleave on device, so the
all_to_all can run while the next chunk computes; whether it does on four
H100s is still to be measured: ROADMAP S3).

The per-chunk partials land pre-partitioned by key hash, so the final
combine is one local grouped aggregate over the concatenated chunk results.
"""

from __future__ import annotations

import functools
from typing import Dict, Iterable, Optional, Tuple

import jax
import jax.numpy as jnp
from jax import shard_map
from jax.sharding import Mesh, PartitionSpec as P

from ..exec.aggregate import grouped_aggregate
from .dist_agg import _COMBINE
from .shuffle import build_send_bins, hash_partition_ids


@functools.lru_cache(maxsize=None)
def _build_chunk_stage(mesh: Mesh, axis: str, fns: Tuple[str, ...], num_groups: int):
    """Jitted: one chunk → exchanged partial groups (keys, aggs, valid)."""
    n_parts = mesh.shape[axis]
    specs = tuple((fns[i], i) for i in range(len(fns)))
    n_cols = len(fns)
    capacity = num_groups

    def shard_fn(local_key, local_cols, local_mask):
        _u, n_grp, rep, outs = grouped_aggregate(
            (local_key,), local_cols, local_mask, num_groups, specs
        )
        pvalid = jnp.arange(num_groups) < n_grp
        pkeys = local_key[jnp.clip(rep, 0, local_key.shape[0] - 1)]
        part = hash_partition_ids(pkeys, n_parts)
        payloads = (pkeys,) + tuple(outs) + (pvalid,)
        bins, bvalid, counts = build_send_bins(part, payloads, n_parts, capacity)
        ex = [
            jax.lax.all_to_all(b, axis, split_axis=0, concat_axis=0, tiled=True)
            for b in bins
        ]
        bx = jax.lax.all_to_all(bvalid, axis, split_axis=0, concat_axis=0, tiled=True)
        k2 = ex[0].reshape(-1)
        partials = tuple(e.reshape(-1) for e in ex[1 : 1 + n_cols])
        valid = bx.reshape(-1) & ex[-1].reshape(-1)
        required = jnp.maximum(n_grp, jnp.max(counts)).reshape(1).astype(jnp.int32)
        return k2, partials, valid, required

    col_specs = tuple(P(axis) for _ in range(n_cols))
    fn = shard_map(
        shard_fn,
        mesh=mesh,
        in_specs=(P(axis), col_specs, P(axis)),
        out_specs=(P(axis), col_specs, P(axis), P(axis)),
        check_vma=False,
    )
    return jax.jit(fn)


@functools.lru_cache(maxsize=None)
def _build_final(
    mesh: Mesh, axis: str, fns: Tuple[str, ...], num_groups: int, n_chunks: int
):
    combine_specs = tuple((_COMBINE[fns[i]], i) for i in range(len(fns)))
    n_cols = len(fns)

    def shard_fn(*chunk_triples):
        # concat the chunks' local partials (locality preserved per shard)
        keys = jnp.concatenate([chunk_triples[3 * c] for c in range(n_chunks)])
        cols = tuple(
            jnp.concatenate(
                [chunk_triples[3 * c + 1][i] for c in range(n_chunks)]
            )
            for i in range(n_cols)
        )
        valid = jnp.concatenate(
            [chunk_triples[3 * c + 2] for c in range(n_chunks)]
        )
        _u, n_grp, rep, outs = grouped_aggregate(
            (keys,), cols, valid, num_groups, combine_specs
        )
        fvalid = jnp.arange(num_groups) < n_grp
        fkeys = keys[jnp.clip(rep, 0, keys.shape[0] - 1)]
        return fkeys, tuple(outs), fvalid, n_grp.reshape(1).astype(jnp.int32)

    col_specs = tuple(P(axis) for _ in range(n_cols))
    in_specs = tuple(
        spec for _ in range(n_chunks) for spec in (P(axis), col_specs, P(axis))
    )
    fn = shard_map(
        shard_fn,
        mesh=mesh,
        in_specs=in_specs,
        out_specs=(P(axis), col_specs, P(axis), P(axis)),
        check_vma=False,
    )
    return jax.jit(fn)


def pipelined_distributed_aggregate(
    mesh: Mesh,
    axis: str,
    chunks: Iterable[Tuple[jax.Array, Dict[str, Tuple[str, jax.Array]], Optional[jax.Array]]],
    num_groups: int = 4096,
):
    """Aggregate a stream of (key, values, mask) chunks across the mesh.

    All chunk stages are dispatched before any result is awaited — the
    exchange of one chunk overlaps the compute of the next.

    Chunks stream through once, so capacity overflow cannot be retried here:
    it raises :class:`CapacityError` (re-run with a larger ``num_groups``).
    """
    from ..errors import CapacityError

    agg_names = None
    chunk_outs = []
    fns = None
    for key, values, mask in chunks:
        if agg_names is None:
            agg_names = tuple(values.keys())
            fns = tuple(values[n][0] for n in agg_names)
        cols = tuple(values[n][1] for n in agg_names)
        stage = _build_chunk_stage(mesh, axis, fns, num_groups)
        if mask is None:
            mask = jnp.ones(key.shape, dtype=jnp.bool_)
        chunk_outs.append(stage(key, cols, mask))  # async dispatch
    if not chunk_outs:
        return None
    # final combine: per-shard local concat of chunk partials (already
    # key-partitioned by the exchanges) + one grouped aggregate
    final = _build_final(mesh, axis, fns, num_groups, len(chunk_outs))
    flat_args = []
    for k2, partials, valid, _req in chunk_outs:
        flat_args.extend([k2, partials, valid])
    fkeys, fouts, fvalid, freq = final(*flat_args)
    need = max(
        int(jax.device_get(jnp.max(freq))),
        max(int(jax.device_get(jnp.max(c[3]))) for c in chunk_outs),
    )
    if need > num_groups:
        raise CapacityError("pipelined aggregate groups", num_groups, need)
    result = {"keys": fkeys, "valid": fvalid}
    for name, o in zip(agg_names, fouts):
        result[name] = o
    return result


def streamed_dataset_aggregate(
    mesh: Mesh,
    axis: str,
    paths,
    key: str,
    aggs: Dict[str, Tuple[str, str]],
    chunk_pages: int = 64,
    num_groups: int = 4096,
    predicates=None,
):
    """BASELINE config-5 shape at dataset scale: stream a (multi-file)
    dataset through the pipelined distributed aggregate without ever
    holding the whole table — chunk i+1 decodes while chunk i's keyed
    all_to_all exchange is in flight.

    ``aggs``: {out_name: (fn, column_name)} over numeric columns; ``key``
    must be numeric (string keys need a global dictionary — use
    ``dist_scan.distributed_scan_dataset`` + ``distributed_aggregate`` for
    those).  File-level zone pruning applies before any chunk decodes.
    """
    from jax.sharding import NamedSharding

    from ..errors import NotYetImplementedError
    from ..exec.dataset import iter_dataset_chunks

    return pipelined_distributed_aggregate(
        mesh,
        axis,
        prepared_dataset_chunks(
            mesh, axis, paths, key, aggs, chunk_pages, predicates
        ),
        num_groups,
    )


def prepared_dataset_chunks(
    mesh: Mesh,
    axis: str,
    paths,
    key: str,
    aggs: Dict[str, Tuple[str, str]],
    chunk_pages: int = 64,
    predicates=None,
):
    """The FEED stage of ``streamed_dataset_aggregate`` on its own: host
    chunk decode → padded sharded device_put, yielding (key, values, mask)
    tuples ready for ``pipelined_distributed_aggregate``.

    Exposed separately so scaling harnesses can time the host-bound feed
    and the device exchange+combine independently (the feed is
    embarrassingly parallel across real hosts — each decodes its own file
    shard with zero communication — so only the exchange stage can
    sub-scale on a pod)."""
    import numpy as np

    from jax.sharding import NamedSharding

    from ..errors import NotYetImplementedError
    from ..exec.dataset import iter_dataset_chunks

    n_shards = mesh.shape[axis]
    sharding = NamedSharding(mesh, P(axis))
    cols = sorted({key} | {c for (_fn, c) in aggs.values()})

    for chunk in iter_dataset_chunks(
        paths, chunk_pages, columns=cols, predicates=predicates
    ):
        kc = chunk[key]
        if kc.dictionary is not None:
            raise NotYetImplementedError(
                "streamed aggregate over dictionary-coded keys "
                "(per-chunk dictionaries are not comparable)"
            )
        n = chunk.num_rows
        padded = -(-max(n, 1) // n_shards) * n_shards

        def _put(c):
            v = c.values
            if padded != v.shape[0]:
                v = jnp.concatenate(
                    [v, jnp.zeros(padded - v.shape[0], dtype=v.dtype)]
                )
            return jax.device_put(v, sharding)

        mask_np = np.zeros(padded, dtype=bool)
        mask_np[:n] = True
        for c in cols:
            if chunk[c].validity is not None:
                mask_np[:n] &= np.asarray(chunk[c].validity)
        mask = jax.device_put(jnp.asarray(mask_np), sharding)
        yield (
            _put(kc),
            {name: (fn, _put(chunk[c])) for name, (fn, c) in aggs.items()},
            mask,
        )
