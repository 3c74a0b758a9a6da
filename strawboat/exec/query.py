"""Fused query API: scan → (pruned) decode → filter → aggregate in one call.

The pipeline composes the planner-driven device scan with the jitted
filter/aggregate stages; zone-map pruning atoms are extracted automatically
from conjunctive predicate expressions (``Expr.atoms``).

    res = (Query("/data/lineitem.str")
           .filter((col("l_shipdate") >= 731) & (col("l_shipdate") < 1096))
           .group_by("l_returnflag")
           .agg(revenue=("sum", "l_extendedprice"))
           .run())
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

from .aggregate import hash_aggregate, scalar_aggregate
from .expr import Expr
from .scan import DeviceTable, scan_file
from .sort import sort_indices, sort_table, take_table


@dataclass
class Query:
    path: str  # file path, glob, list of paths, or a ResidentTable
    _columns: Optional[List[str]] = None
    # resident sources: padding mask over the tiled table (True = real row)
    _base_mask: Optional[object] = None
    _filter: Optional[Expr] = None
    _keys: List[str] = field(default_factory=list)
    _aggs: Dict[str, Tuple[str, str]] = field(default_factory=dict)
    _num_groups: int = 65536
    _order: List = field(default_factory=list)
    _limit: Optional[int] = None
    _distinct: bool = False
    _join: Optional[Tuple] = None  # (build Query, (probe_col, build_col), max_fanout)
    # resident fused grouped path: memoized jitted impl (reuse the Query
    # object across calls to keep the compilation)
    _fused: Optional[object] = None

    def select(self, *columns: str) -> "Query":
        self._columns = list(columns)
        return self

    def filter(self, predicate: Expr) -> "Query":
        self._filter = (
            predicate if self._filter is None else (self._filter & predicate)
        )
        return self

    def group_by(self, *keys: str, num_groups: int = 65536) -> "Query":
        self._keys = list(keys)
        self._num_groups = num_groups
        return self

    def agg(self, **aggs: Tuple[str, str]) -> "Query":
        self._aggs.update(aggs)
        return self

    def join(self, other, on: Tuple[str, str], max_fanout: int = 1) -> "Query":
        """Inner equi-join against another file/query (build side).

        ``on`` = (probe_column, build_column).  Build keys are expected
        near-unique (``max_fanout`` bounds duplicates; overflow grows and
        retries — never silent truncation).  Filters/aggregates applied
        after ``join`` see both sides' columns.
        """
        self._join = (
            other if isinstance(other, Query) else Query(other),
            tuple(on),
            max_fanout,
        )
        return self

    def order_by(self, *items) -> "Query":
        """items: column name or (name, "desc").  On grouped queries the
        names refer to aggregate outputs / ``key_<col>`` columns."""
        self._order = list(items)
        return self

    def limit(self, n: int) -> "Query":
        self._limit = int(n)
        return self

    def distinct(self, num_groups: int = 65536) -> "Query":
        self._distinct = True
        self._num_groups = num_groups
        return self

    # -- execution ------------------------------------------------------

    def scan(self) -> DeviceTable:
        from .resident import ResidentTable

        if isinstance(self.path, ResidentTable):
            # resident source: decoded tiled columns + padding mask
            # (tiled order is a pure permutation — every order-invariant
            # stage below sees exactly the natural-order table)
            cols = self._referenced_columns()
            table, self._base_mask = self.path.as_device_table(cols)
            return table
        predicates = list(self._filter.atoms) if self._filter is not None else None
        cols = self._referenced_columns()
        if not isinstance(self.path, str) or any(c in self.path for c in "*?["):
            # list of files or a glob → multi-file dataset scan (file-level
            # zone pruning + device concat)
            from .dataset import scan_dataset

            return scan_dataset(self.path, columns=cols, predicates=predicates)
        return scan_file(self.path, columns=cols, predicates=predicates)

    def run(self):
        from .resident import ResidentTable

        if (
            isinstance(self.path, ResidentTable)
            and self._join is None
            and not self._distinct
            and self._aggs
        ):
            # keys=[] runs as a single dense group (cap 1): the fused
            # scalar-aggregate shape (Q6 through the DSL)
            fused = self._try_run_resident_fused()
            if fused is not None:
                if self._keys:
                    return fused
                if int(fused["n_groups"]) == 1:
                    return {name: fused[name][0] for name in self._aggs}
                # zero surviving rows: the general path defines the
                # empty-aggregate semantics (rare edge; not worth forking)
        table = self.scan()
        base_mask = self._base_mask
        row_order_sensitive = (
            not self._keys
            and not self._aggs
            and not self._distinct
            and (self._join is None)
        )
        if base_mask is not None and row_order_sensitive:
            # projection / limit / order-by over a resident source: restore
            # natural row order up front (one gather) so "first n rows" and
            # returned tables mean file order, with no padding slots
            import jax.numpy as jnp

            table = take_table(table, self.path.natural_slot_index())
            base_mask = None
        join_valid = None
        if self._join is not None:
            # padding slots are excluded as a probe mask so they never match
            table, join_valid = self._apply_join(table, probe_mask=base_mask)
            base_mask = None  # folded into join_valid
        mask = self._filter.mask(table) if self._filter is not None else None
        if base_mask is not None:
            import jax.numpy as jnp

            mask = base_mask if mask is None else jnp.logical_and(mask, base_mask)
        if join_valid is not None:
            import jax.numpy as jnp

            mask = join_valid if mask is None else jnp.logical_and(mask, join_valid)
        keys, aggs = self._keys, self._aggs
        if self._distinct and not keys:
            cols = self._columns or list(table.columns.keys())
            keys = cols
            aggs = aggs or {"count": ("count", cols[0])}
        if keys:
            res = hash_aggregate(
                table,
                keys=keys,
                aggs=aggs,
                num_groups=self._num_groups,
                mask=mask,
            )
            # key codes are only meaningful against the dictionary of THIS
            # scan (pruning can change the merged dictionary across runs):
            # ship it with the result so callers can decode group keys
            for k in keys:
                d = getattr(table[k], "dictionary", None)
                if d is not None:
                    res[f"dict_{k}"] = d
            if self._order or self._limit is not None:
                res = _order_grouped(res, self._order, self._limit, table)
            return res
        if aggs:
            def _vals(c):
                return c.evaluate(table) if isinstance(c, Expr) else table[c].values

            return {
                name: scalar_aggregate(_vals(c), mask, fn)
                for name, (fn, c) in aggs.items()
            }
        if self._order:
            idx, taken_valid = sort_table(table, self._order, mask, self._limit)
            return take_table(self._projected(table), idx), taken_valid
        if self._limit is not None:
            import jax.numpy as jnp
            import numpy as np

            out_t = self._projected(table)
            if mask is not None:
                # first _limit surviving rows, host-compacted (this path is
                # outside jit) so no padded duplicate rows leak out
                idx = np.flatnonzero(np.asarray(mask))[: self._limit]
                return take_table(out_t, jnp.asarray(idx)), None
            n = min(self._limit, table.num_rows)
            return take_table(out_t, jnp.arange(n)), None
        # projection query: return the table + selection mask
        return self._projected(table), mask

    def _try_run_resident_fused(self):
        """Grouped aggregate over a resident source as ONE jitted call.

        Applicable when every group key is a dict column (dense sorted
        codes): the composite key is ``Σ code_i · stride_i`` — a direct
        segment id, no sort pass — and decode + filter + every aggregate
        fuse behind one jit with ONE packed fetch (whether one fetch per
        query still pays on the H100 is ROADMAP D6).  Returns None when the query
        shape doesn't fit (general path runs instead).  Results are
        host-side numpy, same keys/labels as the general grouped result.
        Reuse the Query object across calls: the jitted impl is memoized on
        it (literals are baked into the trace).
        """
        import jax
        import jax.numpy as jnp
        import numpy as np

        rt = self.path
        keys = self._keys
        for k in keys:
            c = rt.columns.get(k)
            if c is None or not c.is_dict:
                return None
        sizes = [len(rt.columns[k].dictionary_host) for k in keys]
        cap = 1
        for s in sizes:
            cap *= s
        # one-hot grouping FLOPs scale with rows x cap: beyond 4096 composite
        # groups the sort-based general path runs (the H100 cut-over, and
        # whether the matmul pays at all, is ROADMAP D4)
        if cap == 0 or cap > 4096:
            return None
        for fn, _c in self._aggs.values():
            if fn not in ("sum", "count", "min", "max", "avg", "mean"):
                return None
        if self._fused is None:
            agg_items = list(self._aggs.items())
            filt = self._filter
            strides = np.ones(len(keys), dtype=np.int64)
            for i in range(len(keys) - 2, -1, -1):
                strides[i] = strides[i + 1] * sizes[i + 1]
            names = sorted(
                set(keys)
                | set(filt.refs if filt is not None else ())
                | {
                    r
                    for _n, (_f, c) in agg_items
                    for r in (c.refs if isinstance(c, Expr) else (c,))
                }
            )

            def impl(colargs):
                from .resident import _unpack_plane_tiled
                from .scan import DeviceColumn, DeviceTable as _DT

                cols = {}
                for n in names:
                    planes, dictionary, vp = colargs[n]
                    c = rt.columns[n]
                    cols[n] = DeviceColumn(
                        n,
                        c.arrow_type,
                        rt._decode_in_trace(n, planes, dictionary),
                        None if vp is None else _unpack_plane_tiled(vp, 1) != 0,
                        dictionary=c.dictionary_pa,
                    )
                table = _DT(cols, rt.tiled_slots)
                m = rt.mask_tiled()
                if filt is not None:
                    m = m & filt.mask(table)
                code = jnp.zeros(rt.tiled_slots, dtype=jnp.int64)
                for k, st in zip(keys, strides):
                    planes, _d, _vp = colargs[k]
                    kc = rt._decode_in_trace(k, planes, None, with_dict=False)
                    code = code + kc.astype(jnp.int64) * jnp.int64(int(st))
                code32 = code.astype(jnp.int32)

                def _int_group_sum(v, mm):
                    # one-hot matmul grouping, exact via 8-bit planes
                    # (against segment_sum on the H100: ROADMAP D4)
                    from .aggregate import dense_group_sum

                    return dense_group_sum(
                        code32, v.astype(jnp.int64), cap, mask=mm
                    )

                _zero_sums, cnt = _int_group_sum(
                    jnp.zeros(rt.tiled_slots, dtype=jnp.int64), m
                )
                outs = []
                for name_i, (fn, c) in agg_items:
                    if fn == "count":
                        outs.append(cnt)
                        continue
                    if isinstance(c, Expr):
                        v, vm = c.fn(table)
                        mm = m if vm is None else (m & vm)
                    else:
                        v = cols[c].values
                        vv = cols[c].validity
                        mm = m if vv is None else (m & vv)
                    if fn in ("sum", "avg", "mean") and jnp.issubdtype(
                        v.dtype, jnp.integer
                    ):
                        s, c2 = _int_group_sum(v, mm)
                        if fn == "sum":
                            outs.append(s)
                        else:
                            outs.append(
                                s.astype(jnp.float64)
                                / jnp.maximum(c2, 1).astype(jnp.float64)
                            )
                        continue
                    seg = jnp.where(mm, code, cap)
                    if fn in ("sum", "avg", "mean"):
                        s = jax.ops.segment_sum(
                            jnp.where(mm, v, 0), seg, num_segments=cap + 1
                        )[:cap]
                        if fn == "sum":
                            outs.append(s)
                        else:
                            c2 = jax.ops.segment_sum(
                                mm.astype(jnp.int64), seg, num_segments=cap + 1
                            )[:cap]
                            outs.append(
                                s.astype(v.dtype)
                                / jnp.maximum(c2, 1).astype(v.dtype)
                            )
                    else:  # min / max
                        op = (
                            jax.ops.segment_min
                            if fn == "min"
                            else jax.ops.segment_max
                        )
                        if jnp.issubdtype(v.dtype, jnp.floating):
                            neutral = jnp.asarray(
                                jnp.inf if fn == "min" else -jnp.inf, v.dtype
                            )
                        else:
                            info = jnp.iinfo(v.dtype)
                            neutral = info.max if fn == "min" else info.min
                        outs.append(
                            op(
                                jnp.where(mm, v, neutral),
                                seg,
                                num_segments=cap + 1,
                            )[:cap]
                        )

                # TWO fetches total: one int64 stack, one float64 stack;
                # per-row placement is recorded at trace time for the unpack
                out_slot.clear()
                int_rows = [cnt.astype(jnp.int64)]
                flt_rows = []
                for o in outs:
                    if jnp.issubdtype(o.dtype, jnp.floating):
                        out_slot.append(("f", len(flt_rows)))
                        flt_rows.append(o.astype(jnp.float64))
                    else:
                        out_slot.append(("i", len(int_rows)))
                        int_rows.append(o.astype(jnp.int64))
                return (
                    jnp.stack(int_rows),
                    jnp.stack(flt_rows) if flt_rows else jnp.zeros((0, cap)),
                )

            out_slot: list = []
            self._fused = (jax.jit(impl), agg_items, strides, names, out_slot)
        fn_jit, agg_items, strides, names, out_slot = self._fused
        colargs = {
            n: rt._col_args(n) + (rt.columns[n].validity_plane,)
            for n in names
        }
        ints, flts = jax.device_get(fn_jit(colargs))
        ints, flts = np.asarray(ints), np.asarray(flts)
        cnt = ints[0]
        valid = np.flatnonzero(cnt > 0)
        res = {"n_groups": np.int64(len(valid)), "keys": valid.astype(np.uint64)}
        # decode composite group codes back to per-key values (codes are
        # ranks in the SORTED dictionary, so code order == value order)
        rem = valid.copy()
        for k, st in zip(keys, strides):
            codes = rem // int(st)
            rem = rem - codes * int(st)
            c = rt.columns[k]
            if c.kind == "str":
                res[f"key_{k}"] = codes.astype(np.int64)
                res[f"dict_{k}"] = c.dictionary_pa
            else:
                res[f"key_{k}"] = c.dictionary_host[codes]
        for (name, (_fn2, _c)), (kind_s, slot) in zip(agg_items, out_slot):
            row = flts[slot] if kind_s == "f" else ints[slot]
            res[name] = row[valid]
        if self._order or self._limit is not None:
            res = _order_grouped_host(res, self._order, self._limit)
        return res

    def _projected(self, table: DeviceTable) -> DeviceTable:
        """Restrict to the select() projection (scan may carry extra columns
        referenced only by the filter or ORDER BY)."""
        if self._columns is None:
            return table
        return DeviceTable(
            {n: table.columns[n] for n in self._columns}, table.num_rows
        )

    def _apply_join(self, table: DeviceTable, probe_mask=None):
        """Materialize the inner join: gather both sides by the match
        indices; returns (joined table, row-valid mask)."""
        from ..errors import NotYetImplementedError, OutOfSpecError
        from .join import hash_join

        other_q, on, max_fanout = self._join
        build = other_q.scan()
        if other_q._base_mask is not None:
            # resident build side: padded slots must never match — fold the
            # padding mask into the build key's validity
            import dataclasses

            import jax.numpy as jnp

            bk0 = build.columns[on[1]]
            bv0 = (
                other_q._base_mask
                if bk0.validity is None
                else jnp.logical_and(bk0.validity, other_q._base_mask)
            )
            build = DeviceTable(
                {**build.columns, on[1]: dataclasses.replace(bk0, validity=bv0)},
                build.num_rows,
            )
        if other_q._filter is not None:
            # build-side filter: rows failing it must never match — fold the
            # mask into the build key's validity (null keys cannot match)
            import dataclasses

            import jax.numpy as jnp

            bmask = other_q._filter.mask(build)
            bk = build.columns[on[1]]
            bvalid = bmask if bk.validity is None else jnp.logical_and(
                bk.validity, bmask
            )
            build = DeviceTable(
                {**build.columns, on[1]: dataclasses.replace(bk, validity=bvalid)},
                build.num_rows,
            )
        pi, bi, valid = hash_join(
            table, build, on=on, max_fanout=max_fanout, probe_mask=probe_mask
        )

        def _gather(c, idx):
            if getattr(c, "offsets", None) is not None:
                raise NotYetImplementedError(
                    f"join over list column {c.name!r}"
                )
            from .scan import DeviceColumn

            return DeviceColumn(
                c.name,
                c.dtype,
                c.values[idx],
                None if c.validity is None else c.validity[idx],
                c.dictionary,
                # joined f64 values carry device precision; exact bytes do
                # not survive a device gather
                host_exact=None,
            )

        cols = {}
        for name, c in table.columns.items():
            cols[name] = _gather(c, pi)
        for name, c in build.columns.items():
            if name in cols:
                raise OutOfSpecError(
                    f"join: column name {name!r} exists on both sides"
                )
            cols[name] = _gather(c, bi)
        return DeviceTable(cols, int(pi.shape[0])), valid

    def _referenced_columns(self) -> Optional[List[str]]:
        if self._join is not None:
            # probe-side refs cannot be split from build-side refs without a
            # catalog; scan everything (build side scans via its own Query)
            return None
        filter_refs = list(self._filter.refs) if self._filter is not None else []
        if self._filter is not None and not filter_refs:
            # an Expr built outside the tracked constructors: no soundness
            # guarantee — scan everything rather than risk a missing column
            return None
        if self._columns is not None:
            cols = list(self._columns)
            for name in filter_refs:
                if name not in cols:
                    cols.append(name)
            if self._order and not self._keys:
                for item in self._order:
                    name = item[0] if isinstance(item, tuple) else item
                    if name not in cols:
                        cols.append(name)
            return cols
        if not self._keys and not self._aggs:
            return None
        cols = set(self._keys) | set(filter_refs)
        for fn, c in self._aggs.values():
            if isinstance(c, Expr):
                cols.update(c.refs)
            else:
                cols.add(c)
        return sorted(cols)


def _order_grouped_host(res: Dict, order: List, limit: Optional[int]):
    """ORDER BY / LIMIT over a fused grouped result (host numpy: group
    counts are tiny).  String keys sort correctly by their CODES — resident
    dictionaries are globally sorted."""
    import numpy as np

    n = int(res["n_groups"])
    idx = np.arange(n)
    if order:
        # successive stable sorts, least-significant key first → the FIRST
        # order item ends up the primary sort key
        for item in reversed(order):
            name, desc = (
                (item[0], str(item[1]).lower().startswith("desc"))
                if isinstance(item, tuple)
                else (item, False)
            )
            sv = np.asarray(res[name])[:n][idx]
            o = np.argsort(sv, kind="stable")
            if desc:
                o = o[::-1]
            idx = idx[o]
    if limit is not None:
        idx = idx[:limit]
    out = {}
    for k, v in res.items():
        if k == "n_groups":
            out[k] = np.int64(len(idx))
            continue
        if k.startswith("dict_"):
            out[k] = v  # the dictionary itself, not per-group data
            continue
        arr = np.asarray(v)
        out[k] = arr[idx] if arr.ndim >= 1 and arr.shape[0] == n else v
    out["taken_valid"] = np.ones(len(idx), dtype=bool)
    return out


def _order_grouped(
    res: Dict, order: List, limit: Optional[int], table: Optional[DeviceTable] = None
):
    """Sort a grouped-aggregate result dict by output columns (+ LIMIT).

    Only the first ``n_groups`` slots are real groups; the rest sort last.
    ``key_<col>`` sort columns that are dictionary codes of a string column
    in ``table`` order lexically (codes remapped through the dict rank).
    """
    import jax.numpy as jnp

    from .sort import sort_indices

    cap = res["keys"].shape[0]
    valid = jnp.arange(cap) < res["n_groups"]

    def _sort_col(name):
        v = res[name]
        if table is not None and name.startswith("key_"):
            src = table.columns.get(name[4:])
            if src is not None and src.dictionary is not None:
                import numpy as np
                import pyarrow.compute as pc

                order_d = pc.sort_indices(src.dictionary).to_numpy(
                    zero_copy_only=False
                )
                rank = np.empty(len(src.dictionary), dtype=np.int32)
                rank[order_d] = np.arange(len(src.dictionary), dtype=np.int32)
                return jnp.asarray(rank)[jnp.clip(v, 0, len(rank) - 1)]
        return v

    if order:
        names, desc = [], []
        for item in order:
            if isinstance(item, tuple):
                names.append(item[0])
                desc.append(str(item[1]).lower().startswith("desc"))
            else:
                names.append(item)
                desc.append(False)
        cols = tuple(_sort_col(n) for n in names)
        idx = sort_indices(cols, tuple(desc), valid, limit)
    else:
        idx = jnp.arange(cap if limit is None else min(limit, cap))
    out = {}
    for k, v in res.items():
        if k == "n_groups":
            out[k] = jnp.minimum(v, idx.shape[0])
            continue
        if hasattr(v, "shape") and v.ndim >= 1 and v.shape[0] == cap:
            out[k] = v[idx]
        else:
            out[k] = v
    out["taken_valid"] = valid[idx]
    return out
