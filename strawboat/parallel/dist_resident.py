"""Sharded compressed-in-HBM resident tables: config-5 for the serving layer.

The round-4 resident layout packs planes PRE-PERMUTED so tiled slot ``s``
holds natural row ``s`` — which makes the tile axis a ROW axis: sharding
every plane's leading (tile-block) dimension over a mesh gives each device
a contiguous row range, identically aligned across columns and validity
planes.  A grouped aggregate is then embarrassingly combinable: per shard,
decode local planes (the same plane unpack, local shapes) → dense
sorted-dict codes → one-hot partial sums → ONE ``psum`` over the mesh.

No reference counterpart (the reference is single-process); this composes
SURVEY §2.8's distributed backend with the resident serving layer.
"""

from __future__ import annotations


from dataclasses import dataclass
from typing import Any, Dict, Optional, Sequence, Tuple

import numpy as np

from ..exec.resident import ResidentTable


@dataclass
class ShardedResidentColumn:
    name: str
    planes: Tuple[Tuple[Any, int], ...]  # sharded (n_tiles, bits, tile)
    shifts: Tuple[int, ...]
    kind: str
    wide: bool
    offset: int
    bit_shift: int
    dictionary: Any  # device (replicated)
    dictionary_host: Any
    validity_plane: Any  # sharded or None


@dataclass
class ShardedResidentTable:
    columns: Dict[str, ShardedResidentColumn]
    num_rows: int
    tile: int
    mesh: Any
    axis: str
    rows_per_shard: int  # slot count per shard (tile-block aligned)

    def __post_init__(self):
        self._jit_cache: Dict = {}

    def __getitem__(self, name: str) -> ShardedResidentColumn:
        return self.columns[name]


def shard_resident(rt: ResidentTable, mesh, axis: str) -> ShardedResidentTable:
    """Distribute a resident table's planes over ``mesh[axis]``.

    Planes pad with zero tiles to a multiple of the shard count (padding
    rows mask out via the global row count), then ``device_put`` with the
    leading dimension sharded; dictionaries replicate (KB-scale).
    """
    import jax
    import jax.numpy as jnp
    from jax.sharding import NamedSharding, PartitionSpec as P

    n_shards = mesh.shape[axis]
    sharding = NamedSharding(mesh, P(axis))
    repl = NamedSharding(mesh, P())

    def _shard_plane(wt3):
        n_tiles = wt3.shape[0]
        pad = (-n_tiles) % n_shards
        if pad:
            wt3 = jnp.concatenate(
                [wt3, jnp.zeros((pad,) + wt3.shape[1:], wt3.dtype)]
            )
        return jax.device_put(wt3, sharding), wt3.shape[0]

    cols: Dict[str, ShardedResidentColumn] = {}
    total_tiles = None
    for name, c in rt.columns.items():
        if c.kind == "list":
            from ..errors import NotYetImplementedError

            raise NotYetImplementedError(
                f"shard_resident: list column {name!r} (leaf grid differs "
                f"from the row grid; shard the flat columns)"
            )
        planes = []
        for wt3, bits in c.planes:
            sh, nt = _shard_plane(wt3)
            total_tiles = nt
            planes.append((sh, bits))
        vp = None
        if c.validity_plane is not None:
            vp, _ = _shard_plane(c.validity_plane)
        cols[name] = ShardedResidentColumn(
            name,
            tuple(planes),
            c.shifts,
            c.kind,
            c.wide,
            c.offset,
            c.bit_shift,
            None
            if c.dictionary is None
            else jax.device_put(c.dictionary, repl),
            c.dictionary_host,
            vp,
        )
    rows_per_shard = (total_tiles // n_shards) * 32 * rt.tile
    return ShardedResidentTable(
        cols, rt.num_rows, rt.tile, mesh, axis, rows_per_shard
    )


def _bound_scalars_sharded(srt, predicates, pcols):
    import jax.numpy as jnp

    los, his = [], []
    for cname in pcols:
        lo, hi = predicates[cname]
        dh = srt.columns[cname].dictionary_host
        if dh is not None:
            lo = None if lo is None else int(np.searchsorted(dh, lo, "left"))
            hi = None if hi is None else int(np.searchsorted(dh, hi, "left"))
        if predicates[cname][0] is not None:
            los.append(jnp.asarray(lo))
        if predicates[cname][1] is not None:
            his.append(jnp.asarray(hi))
    return tuple(los), tuple(his)


def sharded_filter_sum(
    srt: ShardedResidentTable,
    predicates: Dict[str, Tuple[Optional[float], Optional[float]]],
    value: str,
    product_with: Optional[str] = None,
):
    """Q6 shape over a SHARDED resident table: per-shard fused decode +
    code-space predicates + local sum, combined with one ``psum``."""
    import jax
    import jax.numpy as jnp
    from jax import shard_map
    from jax.sharding import PartitionSpec as P

    predicates = predicates or {}
    pcols = tuple(sorted(predicates))
    flags = tuple(
        (predicates[c][0] is not None, predicates[c][1] is not None)
        for c in pcols
    )
    names = list(
        dict.fromkeys(
            pcols + (value,) + ((product_with,) if product_with else ())
        )
    )
    ck = ("sfs", pcols, flags, value, product_with)
    fn = srt._jit_cache.get(ck)
    mesh, axis = srt.mesh, srt.axis
    rows_per_shard = srt.rows_per_shard
    num_rows = srt.num_rows
    los, his = _bound_scalars_sharded(srt, predicates, pcols)
    if fn is None:
        value_cols = {value} | ({product_with} if product_with else set())

        def shard_fn(colargs, los_, his_):
            from ..exec.resident import _decode_planes, _unpack_plane_tiled

            base = jax.lax.axis_index(axis).astype(jnp.int64) * rows_per_shard
            rows = base + jnp.arange(rows_per_shard, dtype=jnp.int64)
            m = rows < num_rows
            cols = {}
            codes = {}
            for n in names:
                planes, dictionary, vp = colargs[n]
                c = srt.columns[n]
                if n in value_cols:
                    cols[n] = _decode_planes(c, planes, dictionary)
                if n in pcols:
                    codes[n] = _decode_planes(c, planes, None)
                if vp is not None:
                    m = m & (_unpack_plane_tiled(vp, 1) != 0)
            li = hi_i = 0
            for cname, (has_lo, has_hi) in zip(pcols, flags):
                cv = codes[cname]
                if has_lo:
                    m = m & (cv >= los_[li])
                    li += 1
                if has_hi:
                    m = m & (cv < his_[hi_i])
                    hi_i += 1
            acc = cols[value]
            if product_with is not None:
                acc = acc.astype(
                    acc.dtype
                    if jnp.issubdtype(acc.dtype, jnp.floating)
                    else jnp.int64
                ) * cols[product_with]
            dt = (
                jnp.float64
                if jnp.issubdtype(acc.dtype, jnp.floating)
                else jnp.int64
            )
            return jax.lax.psum(
                jnp.sum(jnp.where(m, acc, 0), dtype=dt), axis
            )

        in_spec_col = {
            n: (
                tuple(P(axis) for _p in srt.columns[n].planes),
                None if srt.columns[n].dictionary is None else P(),
                None if srt.columns[n].validity_plane is None else P(axis),
            )
            for n in names
        }
        fn = jax.jit(
            shard_map(
                shard_fn,
                mesh=mesh,
                in_specs=(
                    in_spec_col,
                    tuple(P() for _ in los),
                    tuple(P() for _ in his),
                ),
                out_specs=P(),
                check_vma=False,
            )
        )
        srt._jit_cache[ck] = fn
    colargs = {
        n: (
            tuple(w for w, _b in srt.columns[n].planes),
            srt.columns[n].dictionary,
            srt.columns[n].validity_plane,
        )
        for n in names
    }
    return fn(colargs, los, his)


def sharded_group_sum(
    srt: ShardedResidentTable,
    key: str,
    values: Sequence[str],
    num_groups: int,
    predicates: Optional[Dict[str, Tuple[Optional[float], Optional[float]]]] = None,
):
    """Per-group sums + counts over a SHARDED resident table.

    One jitted shard_map: each device decodes only ITS plane slice, builds
    the dense key (dict CODES — the sorted global dictionary is shared, so
    codes are comparable across shards), computes one-hot matmul partial sums
    over local rows, and a single ``psum`` over the mesh yields the exact
    global result on every shard.  Bound literals translate to code space
    host-side exactly like the single-chip fast path.
    """
    import jax
    import jax.numpy as jnp
    from jax import shard_map
    from jax.sharding import PartitionSpec as P

    from ..exec.aggregate import dense_group_sum
    from ..exec.resident import _decode_planes, _unpack_plane_tiled

    predicates = predicates or {}
    pcols = tuple(sorted(predicates))
    flags = tuple(
        (predicates[c][0] is not None, predicates[c][1] is not None)
        for c in pcols
    )
    names = list(dict.fromkeys((key,) + tuple(values) + pcols))
    ck = ("sgs", key, tuple(values), num_groups, pcols, flags)
    fn = srt._jit_cache.get(ck)
    mesh, axis = srt.mesh, srt.axis
    rows_per_shard = srt.rows_per_shard
    num_rows = srt.num_rows

    # host-side code-space bound translation (sorted global dictionaries)
    los, his = _bound_scalars_sharded(srt, predicates, pcols)

    if fn is None:

        def shard_fn(colargs, los_, his_):
            shard_i = jax.lax.axis_index(axis)
            base = shard_i.astype(jnp.int64) * rows_per_shard
            cols = {}
            codes = {}
            # local slot s is global row base + s (slot == row)
            rows = base + jnp.arange(rows_per_shard, dtype=jnp.int64)
            m = rows < num_rows
            for n in names:
                planes, dictionary, vp = colargs[n]
                c = srt.columns[n]
                if n in (key,) + tuple(pcols):
                    codes[n] = _decode_planes(c, planes, None)
                if n in values:
                    cols[n] = _decode_planes(c, planes, dictionary)
                if vp is not None:
                    # null rows never count (matches the single-chip path)
                    m = m & (_unpack_plane_tiled(vp, 1) != 0)
            li = hi_i = 0
            for cname, (has_lo, has_hi) in zip(pcols, flags):
                cv = codes[cname]
                if has_lo:
                    m = m & (cv >= los_[li])
                    li += 1
                if has_hi:
                    m = m & (cv < his_[hi_i])
                    hi_i += 1
            k = codes[key].astype(jnp.int32)
            outs = []
            cnt = None
            for vname in values:
                vv = cols[vname]
                # one-hot FLOPs scale with rows x groups: beyond 4096
                # groups the scatter path runs (the cut-over on the H100 is
                # ROADMAP D4)
                if jnp.issubdtype(vv.dtype, jnp.floating) or num_groups > 4096:
                    seg = jnp.where(m, k, num_groups)
                    s = jax.ops.segment_sum(
                        jnp.where(m, vv, 0), seg, num_segments=num_groups + 1
                    )[:num_groups]
                    c2 = jax.ops.segment_sum(
                        m.astype(jnp.int64), seg, num_segments=num_groups + 1
                    )[:num_groups]
                else:
                    s, c2 = dense_group_sum(
                        k, vv.astype(jnp.int64), num_groups, mask=m
                    )
                outs.append(jax.lax.psum(s, axis))
                if cnt is None:
                    cnt = jax.lax.psum(c2, axis)
            return tuple(outs), cnt

        in_spec_col = {
            n: (
                tuple(P(axis) for _p in srt.columns[n].planes),
                None if srt.columns[n].dictionary is None else P(),
                None if srt.columns[n].validity_plane is None else P(axis),
            )
            for n in names
        }
        fn = jax.jit(
            shard_map(
                shard_fn,
                mesh=mesh,
                in_specs=(
                    in_spec_col,
                    tuple(P() for _ in los),
                    tuple(P() for _ in his),
                ),
                out_specs=(
                    tuple(P() for _ in values),
                    P(),
                ),
                check_vma=False,
            )
        )
        srt._jit_cache[ck] = fn
    colargs = {
        n: (
            tuple(w for w, _b in srt.columns[n].planes),
            srt.columns[n].dictionary,
            srt.columns[n].validity_plane,
        )
        for n in names
    }
    return fn(colargs, los, his)
