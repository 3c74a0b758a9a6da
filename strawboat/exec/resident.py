"""Resident tables: packed pages kept in device memory, decoded per query.

``scan_file`` materializes decoded columns in device memory (8B/row for
int64).  A *resident* table instead keeps bit-packed PLANES there (b/32 of
the decoded size per 32-bit plane; dict columns keep packed CODES + the tiny
dictionary) and decodes on the fly inside each query: the plane unpack is
plain jnp, so XLA fuses it into the filter and the reduce that consume it.
Its rate on the H100 is ``bench.py``'s ``resident_scan_bandwidth``.

Column representation (full format coverage): every column the
host reader can decode loads, regardless of the file's page codecs
(BP / ΔBP / RLE / Dict-any-index / Freq / OneValue / raw / Patas — the
loader decodes through the complete host read path and re-encodes into the
resident layout, so tail pages, mixed dict/plain pages and every codec the
writer's chooser emits are covered by construction):

* ``int``    — 1–2 planes of ≤32 bits over ``value - offset`` (offset strip
  covers negative and wide int64); single ≤31-bit plane with offset 0
  decodes straight to int32 (the fast path).
* ``f32``/``f64`` — bitcast planes over ``(bits >> tz) - offset`` where
  ``tz`` is the common-trailing-zero count (Patas-ish) — lossless at rest.
* ``dict``   — packed codes + GLOBAL SORTED dictionary (device array for
  value decode via the one-hot matmul gather; host copy for translating value
  predicates into CODE-range predicates so filters never gather at all).
  Strings always dict-encode (codes are the device column; the sorted
  ``pa.Array`` dictionary rides on the DeviceColumn for literal
  translation, ordering and materialization).
* ``bool``   — one 1-bit plane.
* nullable   — a 1-bit validity plane per column.

Row order: packing PRE-PERMUTES values so the tiled kernel's t-major
output IS natural row order (the pack→unpack pipeline is a fixed
width-independent permutation; its inverse is a pure reshape/transpose
applied once at load).  Tiled slot s therefore holds natural row s for every plane of
every column — cross-column predicates/aggregations align trivially,
padding is the tail, and NATURAL-order materialization costs no reorder
of any kind.

Query access paths:

* ``filter_sum`` / ``group_sum`` — fused single-jit fast paths (the bench
  shapes).
* ``as_device_table()`` — decoded tiled columns as a regular
  :class:`DeviceTable` + padding mask, so the WHOLE query stack
  (``Query.filter/group_by/agg/join/order_by``, expression DSL, string
  dictionaries) runs over resident data unchanged.
* ``to_arrow()`` — natural-order materialization (free: tiled output is
  already natural order, just truncated).

Capability note vs the reference: the reference decodes to host memory and
has no resident representation (src/read/batch_read.rs); this is the
device-side extension of its page layouts (BitPacker4x blocks
integer/bp.rs:36-86; dict pages integer/dict.rs:34-102) to in-memory
serving.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, Optional, Sequence, Tuple

import numpy as np
import pyarrow as pa

from ..errors import NotYetImplementedError, OutOfSpecError

_MAX_DICT = 1 << 20  # dictionary entries beyond this: plain planes instead


@dataclass
class ResidentColumn:
    name: str
    # 1–2 packed planes, LSB-first: (wt3 (n_tiles, bits, tile) u32, bits)
    planes: Tuple[Tuple[Any, int], ...]
    shifts: Tuple[int, ...]  # bit position of each plane in the payload
    length: int  # true row count (tiled slots beyond are padding)
    kind: str  # 'int' | 'f32' | 'f64' | 'bool' | 'str'
    # payload = ((Σ plane_i << shift_i) + offset) << bit_shift   (mod 2^64;
    # then bitcast per kind).  offset is stored as the two's-complement u64.
    offset: int = 0
    bit_shift: int = 0
    # int kind: decode to int64 when the ARROW storage is 64-bit (int64 /
    # timestamp / decimal) even if the packed values are narrow — consumers
    # (expressions, products) must see scan-path dtypes, or a per-row
    # int32 product silently wraps (found by resident Q1 on chip)
    wide: bool = False
    # dict columns only: GLOBAL SORTED dictionary.  Sortedness is the point:
    # a value-range predicate becomes a CODE-range predicate (host
    # searchsorted) — filters never gather; only value decodes pay one
    # small gather.
    dictionary: Any = None  # device values (i32/i64/f32/f64); None for str
    dictionary_host: Any = None  # np sorted values (bound translation)
    dictionary_pa: Any = None  # pa.Array sorted (strings: DeviceColumn dict)
    validity_plane: Any = None  # wt3 of a 1-bit plane, or None (all valid)
    arrow_type: Any = None
    # list kind only: the planes above hold per-row LENGTHS (composed
    # row→leaf counts — small ints, they pack tightly); the flattened leaf
    # values are a full ResidentColumn over their OWN tiled grid.  Depth
    # recurses (list<list<…>> children are themselves 'list' columns).
    child: Optional["ResidentColumn"] = None
    # struct kind only (loader-internal): per-field child columns, all on
    # the PARENT row grid — make_resident unnests them to `parent.field`
    # table columns (the scan layer's convention) and records the
    # reassembly in ResidentTable.struct_specs
    children: Any = None

    @property
    def wt3(self):  # diagnostic back-compat (plane 0 words)
        return self.planes[0][0]

    @property
    def num_bits(self) -> int:
        return self.planes[0][1]

    @property
    def is_dict(self) -> bool:
        return self.dictionary_host is not None

    @property
    def tiled_slots(self) -> int:
        n_tiles, _b, tile = self.planes[0][0].shape
        return n_tiles * tile * 32

    def decoded_dtype(self):
        import jax.numpy as jnp

        if self.is_dict:
            if self.kind == "str":
                return jnp.int32  # codes
            return self.dictionary.dtype
        if self.kind == "bool":
            return jnp.bool_
        if self.kind == "f32":
            return jnp.float32
        if self.kind == "f64":
            return jnp.float64
        if (
            len(self.planes) == 1
            and self.offset == 0
            and self.bit_shift == 0
            and self.planes[0][1] <= 31
            and not self.wide
        ):
            return jnp.int32  # also covers 'list' (length planes)
        return jnp.int64


# Plane layout: a plane is (n_tiles, b, TILE3D) u32 words; tile lane j of
# word row w holds the w-th packed word of lane j's 32-value bit stream.
# The tile width and the (n_tiles, b, tile) shape are inherited from the
# first accelerator this engine ran on; whether a different tile suits the
# H100 is ROADMAP D3.
TILE3D = 16384


def transpose_words_host_tiled(
    words: np.ndarray, b: int, tile: int = TILE3D
) -> np.ndarray:
    """(n_blocks * 4b,) BitPacker4x words → (n_tiles, b, tile) plane words,
    the lane axis zero-padded to whole tiles."""
    n_blocks = words.size // (4 * b)
    w = words.reshape(n_blocks, b, 4)  # [block, word, lane]
    wt = w.transpose(1, 0, 2).reshape(b, n_blocks * 4)
    pad = (-wt.shape[1]) % tile
    if pad:
        wt = np.pad(wt, ((0, 0), (0, pad)))
    n_tiles = wt.shape[1] // tile
    return np.ascontiguousarray(wt.reshape(b, n_tiles, tile).transpose(1, 0, 2))


def _slot_source_index(n_tiles: int, tile: int) -> np.ndarray:
    """Input index feeding tiled output slot s, for BitPacker4x blocks laid
    out by ``transpose_words_host_tiled`` and unpacked by
    ``_unpack_plane_tiled`` (host numpy; the statement of the mapping).

    slot (tile_i, t, lane): lane_global = tile_i*tile + lane = 4*blk + l;
    source = 128*blk + 4*t + l — independent of the bit width.

    Resident packing feeds values through this permutation's INVERSE (a
    pure reshape/transpose in ``_pack_plane``), so decoded tiled order IS
    natural row order.
    """
    shape = (n_tiles, 32, tile)
    ti, t, lane = np.indices(shape, sparse=True)
    lane_g = ti * tile + lane
    nat = 128 * (lane_g // 4) + 4 * t + (lane_g % 4)
    return np.broadcast_to(nat, shape).reshape(-1)


def _unpack_plane_tiled(wt3, bits: int):
    """One packed plane (n_tiles, bits, tile) → flat uint32 values in
    tiled-slot order, which is natural row order.

    The exact inverse of ``_pack_plane_device``, in plain jnp: inside a
    query's jit XLA fuses these shifts and masks into the filter and the
    reduce that consume them, so the decoded values never reach device
    memory.  Divisor widths (b | 32) are P = 32/b shifted copies of each
    word row; other widths extract each of the 32 values with the carry
    from the next word."""
    import jax.numpy as jnp

    n_tiles, b, tile = wt3.shape
    if bits == 0:
        return jnp.zeros(n_tiles * 32 * tile, dtype=jnp.uint32)
    assert b == bits, (b, bits)
    mask = jnp.uint32(0xFFFFFFFF >> (32 - b))
    if 32 % b == 0:
        # value t = j*P + p lives in word j at bit offset p*b
        shifts = jnp.arange(32 // b, dtype=jnp.uint32) * jnp.uint32(b)
        out = (wt3[:, :, None, :] >> shifts[None, None, :, None]) & mask
        return out.reshape(-1)
    rows = []
    for t in range(32):
        w0, sh = divmod(t * b, 32)
        v = wt3[:, w0, :] >> jnp.uint32(sh)
        if sh + b > 32:
            v = v | (wt3[:, w0 + 1, :] << jnp.uint32(32 - sh))
        rows.append(v & mask)
    return jnp.stack(rows, axis=1).reshape(-1)


def _decode_planes(c, planes_wt3, dictionary, with_dict: bool = True):
    """Packed planes of ``c`` (a ResidentColumn, or a ShardedResidentColumn
    over its local slices) → decoded column values in tiled-slot order.

    Dict columns decode through ``dictionary`` unless ``with_dict`` is
    False or there is none (code space — the predicate representation)."""
    import jax
    import jax.numpy as jnp

    vals = [
        _unpack_plane_tiled(wt3, bits)
        for wt3, (_w, bits) in zip(planes_wt3, c.planes)
    ]
    if c.dictionary_host is not None:
        codes = vals[0].astype(jnp.int32)
        if with_dict and dictionary is not None:
            from ..kernels.decode import dict_gather_device

            return dict_gather_device(codes, dictionary)
        return codes
    if c.kind == "bool":
        return vals[0] != 0
    if c.kind == "f32":
        u = vals[0]
        if c.offset:
            u = u + jnp.uint32(c.offset & 0xFFFFFFFF)
        if c.bit_shift:
            u = u << jnp.uint32(c.bit_shift)
        return jax.lax.bitcast_convert_type(u, jnp.float32)
    if (
        len(c.planes) == 1
        and c.offset == 0
        and c.bit_shift == 0
        and c.planes[0][1] <= 31
        and c.kind in ("int", "list")
    ):
        v = vals[0].astype(jnp.int32)  # values < 2^31
        return v.astype(jnp.int64) if c.wide else v
    u = jnp.zeros_like(vals[0], dtype=jnp.uint64)
    for v, sh in zip(vals, c.shifts):
        u = u | (v.astype(jnp.uint64) << jnp.uint64(sh))
    if c.offset:
        u = u + jnp.uint64(c.offset)
    if c.bit_shift:
        u = u << jnp.uint64(c.bit_shift)
    if c.kind == "f64":
        return jax.lax.bitcast_convert_type(u, jnp.float64)
    return jax.lax.bitcast_convert_type(u, jnp.int64)


@dataclass
class ResidentTable:
    columns: Dict[str, ResidentColumn]
    num_rows: int
    tile: int
    # struct reassembly: {struct_name: (((field, column_name), ...),
    # validity_plane, arrow_type)} — children live as ordinary dotted
    # table columns (same row grid), the spec only drives to_arrow
    struct_specs: Optional[Dict[str, Any]] = None
    # original top-level schema order (struct names, not dotted children)
    field_order: Optional[Any] = None

    def __post_init__(self):
        self._jit_cache: Dict = {}
        self._bounds_cache: Dict = {}

    def __getitem__(self, name: str) -> ResidentColumn:
        return self.columns[name]

    @property
    def tiled_slots(self) -> int:
        return next(iter(self.columns.values())).tiled_slots

    def _grid(self):
        c = next(iter(self.columns.values()))
        n_tiles, _b, tile = c.planes[0][0].shape
        return n_tiles, tile

    def mask_tiled(self):
        """Padding mask (True = real row).  The load-time pre-permutation
        makes tiled slot s hold natural row s, so padding is the tail."""
        import jax.numpy as jnp

        return jnp.arange(self.tiled_slots, dtype=jnp.int32) < self.num_rows

    def natural_slot_index(self):
        """slot of natural row i — the IDENTITY under the pre-permuted
        packing (kept for callers that need an index array)."""
        import jax.numpy as jnp

        return jnp.arange(self.num_rows, dtype=jnp.int32)

    # -- decode --------------------------------------------------------

    def _decode_in_trace(self, name, planes_wt3, dictionary, with_dict=True):
        """decode_tiled body over traced inputs (used inside fused jits)."""
        return _decode_planes(
            self.columns[name], planes_wt3, dictionary, with_dict
        )

    def _col_args(self, name: str):
        c = self.columns[name]
        return (tuple(wt3 for wt3, _b in c.planes), c.dictionary)

    def decode_tiled(self, name: str, with_dict: bool = True):
        """Column values in tiled order, padding slots included.

        Dict columns decode through the dictionary unless ``with_dict`` is
        False (code space — the predicate representation).  Strings always
        return codes."""
        c = self.columns[name]
        return _decode_planes(
            c, [w for w, _b in c.planes], c.dictionary, with_dict
        )

    def validity_tiled(self, name: str):
        """Validity (True = non-null) in tiled order, or None (all valid)."""
        c = self.columns[name]
        if c.validity_plane is None:
            return None
        return _unpack_plane_tiled(c.validity_plane, 1) != 0

    def decode_natural(self, name: str, with_dict: bool = True):
        """Column values in NATURAL row order (true length).

        Free under the pre-permuted packing: tiled slot s IS natural row s,
        so this is ``decode_tiled`` truncated — no reorder of any kind."""
        return self.decode_tiled(name, with_dict)[: self.num_rows]

    def validity_natural(self, name: str):
        v = self.validity_tiled(name)
        return None if v is None else v[: self.num_rows]

    # -- whole-table views ---------------------------------------------

    def as_device_table(self, columns: Optional[Sequence[str]] = None):
        """Decoded tiled columns as a regular DeviceTable + padding mask.

        The returned table has ``tiled_slots`` rows; the mask marks the
        ``num_rows`` real ones.  Order-invariant consumers (filter,
        aggregate, join — the whole grouped-query stack) give results equal
        to the natural-order table; row-order-sensitive paths restore
        natural order via :meth:`natural_slot_index`.
        """
        from .scan import DeviceColumn, DeviceTable

        names = list(columns) if columns is not None else list(self.columns)
        cols = {}
        for n in names:
            c = self.columns[n]
            if c.kind == "list":
                raise NotYetImplementedError(
                    f"list column {n!r} in as_device_table — lists serve "
                    f"via list_sum / to_arrow (their leaf grid differs "
                    f"from the row grid)"
                )
            vals = self.decode_tiled(n)
            cols[n] = DeviceColumn(
                n,
                c.arrow_type,
                vals,
                self.validity_tiled(n),
                dictionary=c.dictionary_pa,
            )
        return DeviceTable(cols, self.tiled_slots), self.mask_tiled()

    def _decode_col(self, c: ResidentColumn, with_dict: bool = True):
        """Natural-order decode of an explicit column (incl. list children:
        their tiled grid is their own, natural leaf order)."""
        planes = [w for w, _b in c.planes]
        return _decode_planes(c, planes, c.dictionary, with_dict)[: c.length]

    def _col_validity(self, c: ResidentColumn):
        if c.validity_plane is None:
            return None
        return (_unpack_plane_tiled(c.validity_plane, 1) != 0)[: c.length]

    def _materialize_pa(self, c: ResidentColumn) -> pa.Array:
        """One column (or list/struct child) → natural-order pa.Array."""
        if c.kind == "struct":
            children = [
                self._materialize_pa(cc) for cc in c.children.values()
            ]
            validity = self._col_validity(c)
            mask = (
                None if validity is None
                else pa.array(~np.asarray(validity))
            )
            return pa.StructArray.from_arrays(
                children, fields=list(c.arrow_type), mask=mask
            )
        if c.kind == "list":
            lengths = np.asarray(self._decode_col(c), dtype=np.int64)
            validity = self._col_validity(c)
            mask = None if validity is None else ~np.asarray(validity)
            offsets = np.zeros(len(lengths) + 1, dtype=np.int64)
            np.cumsum(lengths, out=offsets[1:])
            child_arr = self._materialize_pa(c.child)
            if c.arrow_type is not None and pa.types.is_map(c.arrow_type):
                # child is struct<key, value>: split and rebuild the map
                arr = pa.MapArray.from_arrays(
                    pa.array(offsets.astype(np.int32)),
                    child_arr.field(0),
                    child_arr.field(1),
                    mask=None if mask is None else pa.array(mask),
                )
                if arr.type != c.arrow_type:
                    arr = arr.cast(c.arrow_type)
                return arr
            large = c.arrow_type is not None and pa.types.is_large_list(
                c.arrow_type
            )
            cls = pa.LargeListArray if large else pa.ListArray
            odt = np.int64 if large else np.int32
            arr = cls.from_arrays(
                pa.array(offsets.astype(odt)),
                child_arr,
                mask=None if mask is None else pa.array(mask),
            )
            if c.arrow_type is not None and arr.type != c.arrow_type:
                arr = arr.cast(c.arrow_type)
            return arr
        vals = np.asarray(self._decode_col(c))
        validity = self._col_validity(c)
        mask = None if validity is None else ~np.asarray(validity)
        return self._flat_to_pa(c, vals, mask)

    def _materialize_name(self, n: str) -> pa.Array:
        if self.struct_specs and n in self.struct_specs:
            names, vplane, atype = self.struct_specs[n]
            children = [self._materialize_name(cn) for _sub, cn in names]
            mask = None
            if vplane is not None:
                valid = (_unpack_plane_tiled(vplane, 1) != 0)[: self.num_rows]
                mask = pa.array(~np.asarray(valid))
            return pa.StructArray.from_arrays(
                children, fields=list(atype), mask=mask
            )
        return self._materialize_pa(self.columns[n])

    def to_arrow(self, columns: Optional[Sequence[str]] = None) -> pa.Table:
        """Natural-order host materialization (round-trips the loaded data:
        struct columns reassemble from their dotted child columns)."""
        if columns is not None:
            names = list(columns)
        else:
            names = list(self.field_order or self.columns)
        arrays = {}
        for n in names:
            arrays[n] = self._materialize_name(n)
        return pa.table(arrays)

    def _flat_to_pa(self, c: ResidentColumn, vals, mask) -> pa.Array:
        if c.kind == "str":
            arr = c.dictionary_pa.take(
                pa.array(vals, mask=mask)
            )
            if arr.type != c.arrow_type:
                arr = arr.cast(c.arrow_type)
        elif c.arrow_type is not None and pa.types.is_decimal(c.arrow_type):
            # vals are UNSCALED ints — rebuild the 16-byte limb matrix
            # (an int64→decimal cast would re-scale the value)
            v = np.asarray(vals, dtype=np.int64)
            limbs = np.empty((len(v), 2), dtype="<i8")
            limbs[:, 0] = v
            limbs[:, 1] = v >> 63
            null_bm = None
            if mask is not None:
                null_bm = pa.py_buffer(
                    np.packbits(~mask, bitorder="little").tobytes()
                )
            arr = pa.Array.from_buffers(
                c.arrow_type,
                len(v),
                [null_bm, pa.py_buffer(limbs.tobytes())],
            )
        else:
            arr = pa.array(vals, mask=mask)
            if c.arrow_type is not None and arr.type != c.arrow_type:
                try:
                    arr = arr.cast(c.arrow_type)
                except (pa.ArrowInvalid, pa.ArrowNotImplementedError):
                    # date32 & friends only cast from their storage
                    # width; round-trip through the storage int type
                    storage = pa.int32() if c.arrow_type.bit_width == 32 else pa.int64()
                    arr = arr.cast(storage).cast(c.arrow_type)
        return arr

    # -- bound translation ---------------------------------------------

    def _code_bounds(self, col: str, lo, hi):
        """Translate VALUE bounds to CODE bounds for sorted-dict columns.

        The global dictionary is sorted, so [lo, hi) over values equals
        [searchsorted(lo), searchsorted(hi)) over codes — the filter needs
        no dictionary gather at all.
        """
        c = self.columns[col]
        if c.dictionary_host is None:
            return lo, hi, False
        d = c.dictionary_host
        lo_c = None if lo is None else int(np.searchsorted(d, lo, "left"))
        hi_c = None if hi is None else int(np.searchsorted(d, hi, "left"))
        return lo_c, hi_c, True

    def _bound_scalars(self, predicates, pcols):
        """Device scalars for the lo/hi literals (code-space for dict
        columns, value-space otherwise), cached by value, so a repeated
        query uploads no fresh scalars."""
        import jax.numpy as jnp

        key = tuple((c,) + tuple(predicates[c]) for c in pcols)
        hit = self._bounds_cache.get(key)
        if hit is None:
            los, his = [], []
            for cname in pcols:
                lo, hi = predicates[cname]
                lo, hi, is_code = self._code_bounds(cname, lo, hi)
                c = self.columns[cname]
                dt = jnp.int32 if is_code else c.decoded_dtype()
                if predicates[cname][0] is not None:
                    los.append(jnp.asarray(lo, dtype=dt))
                if predicates[cname][1] is not None:
                    his.append(jnp.asarray(hi, dtype=dt))
            hit = (tuple(los), tuple(his))
            self._bounds_cache[key] = hit
        return hit

    def _predicate_mask_in_trace(self, pcols, flags, codes, los, his, m):
        li = hi_i = 0
        for cname, (has_lo, has_hi) in zip(pcols, flags):
            cv = codes[cname]
            if has_lo:
                m = m & (cv >= los[li])
                li += 1
            if has_hi:
                m = m & (cv < his[hi_i])
                hi_i += 1
        return m

    # -- order-invariant fused query ops --------------------------------

    def filter_sum(
        self,
        predicates: Dict[str, Tuple[Optional[float], Optional[float]]],
        value: str,
        product_with: Optional[str] = None,
    ):
        """sum(value [* product_with]) where every predicate col in [lo, hi).

        The Q6 shape.  Decode + predicate + reduce fuse into ONE jitted
        call (cached per query shape; bound VALUES are traced, so changing
        a constant does not recompile).  Nothing is restored to natural
        order.  Bounds are half-open; None = unbounded.  Dict predicate
        columns compare in CODE space (no gather); null rows never count.
        """
        import jax
        import jax.numpy as jnp

        pcols = tuple(sorted(predicates))
        flags = tuple(
            (predicates[c][0] is not None, predicates[c][1] is not None)
            for c in pcols
        )
        key = ("fs", pcols, flags, value, product_with)
        fn = self._jit_cache.get(key)
        names = list(
            dict.fromkeys(
                pcols + (value,) + ((product_with,) if product_with else ())
            )
        )
        if fn is None:
            value_cols = {value} | ({product_with} if product_with else set())

            def impl(colargs, vplanes, los, his):
                # predicate-only columns stay in CODE space (no gather);
                # summed columns decode through the dictionary
                cols = {}
                codes = {}
                for n in names:
                    planes, dictionary = colargs[n]
                    if n in value_cols:
                        cols[n] = self._decode_in_trace(n, planes, dictionary)
                    if n in pcols:
                        codes[n] = self._decode_in_trace(
                            n, planes, None, with_dict=False
                        )
                m = self.mask_tiled()
                for vp in vplanes:
                    m = m & (_unpack_plane_tiled(vp, 1) != 0)
                m = self._predicate_mask_in_trace(
                    pcols, flags, codes, los, his, m
                )
                acc = cols[value]
                if product_with is not None:
                    acc = acc.astype(
                        acc.dtype
                        if jnp.issubdtype(acc.dtype, jnp.floating)
                        else jnp.int64
                    ) * cols[product_with]
                if jnp.issubdtype(acc.dtype, jnp.floating):
                    return jnp.sum(jnp.where(m, acc, 0), dtype=jnp.float64)
                return jnp.sum(jnp.where(m, acc, 0), dtype=jnp.int64)

            fn = jax.jit(impl)
            self._jit_cache[key] = fn
        colargs = {n: self._col_args(n) for n in names}
        vplanes = tuple(
            self.columns[n].validity_plane
            for n in names
            if self.columns[n].validity_plane is not None
        )
        los, his = self._bound_scalars(predicates, pcols)
        return fn(colargs, vplanes, los, his)

    def list_sum(self, name: str):
        """Per-row sum over a ``list<numeric>`` column — ONE fused jit:
        length-plane decode → device cumsum offsets → leaf-plane decode →
        ``list_segment_sum``.  Null leaf elements contribute 0; null rows
        sum to 0 (mask via ``validity_natural``).  The resident analogue
        of the scan layer's DeviceListColumn + list_segment_sum path
        (ref semantics: /root/reference/src/read/batch_read.rs:66-187)."""
        import jax
        import jax.numpy as jnp

        from .aggregate import list_segment_sum

        c = self.columns[name]
        if c.kind != "list":
            raise OutOfSpecError(f"{name!r} is not a list column")
        child = c.child
        if child.kind not in ("int", "f32", "f64"):
            raise NotYetImplementedError(f"list_sum over list<{child.kind}>")
        key = ("lsum", name)
        fn = self._jit_cache.get(key)
        if fn is None:
            n_rows = self.num_rows
            has_cv = child.validity_plane is not None

            def impl(len_planes, child_planes, cv_plane, dictionary):
                lengths = _decode_planes(c, len_planes, None)[
                    :n_rows
                ].astype(jnp.int32)
                offsets = jnp.concatenate(
                    [jnp.zeros(1, jnp.int32), jnp.cumsum(lengths)]
                )
                vals = _decode_planes(
                    child, child_planes, dictionary
                )[: child.length]
                if not jnp.issubdtype(vals.dtype, jnp.floating):
                    vals = vals.astype(jnp.int64)
                if has_cv:
                    cv = (_unpack_plane_tiled(cv_plane, 1) != 0)[
                        : child.length
                    ]
                    vals = jnp.where(cv, vals, 0)
                return list_segment_sum(vals, offsets, n_rows)

            fn = jax.jit(impl)
            self._jit_cache[key] = fn
        sums = fn(
            tuple(w for w, _b in c.planes),
            tuple(w for w, _b in child.planes),
            child.validity_plane,
            child.dictionary,
        )
        v = self.validity_natural(name)
        if v is not None:
            import jax.numpy as jnp

            sums = jnp.where(v, sums, 0)
        return sums

    def group_sum(
        self,
        key: str,
        values: Sequence[str],
        num_groups: int,
        predicates: Optional[Dict[str, Tuple[Optional[float], Optional[float]]]] = None,
    ):
        """Per-group sums + counts over dense integer keys in [0, num_groups).

        Grouping is a segment-sum over tiled order — permutation-invariant,
        so results equal the natural-order aggregate exactly.  For dict key
        columns the group id is the (sorted) dictionary CODE; translate via
        ``columns[key].dictionary_host``.
        """
        import jax
        import jax.numpy as jnp

        predicates = predicates or {}
        pcols = tuple(sorted(predicates))
        flags = tuple(
            (predicates[c][0] is not None, predicates[c][1] is not None)
            for c in pcols
        )
        ck = ("gs", key, tuple(values), num_groups, pcols, flags)
        fn = self._jit_cache.get(ck)
        names = list(dict.fromkeys((key,) + tuple(values) + pcols))
        if fn is None:
            value_cols = set(values)

            def impl(colargs, vplanes, los, his):
                cols = {}
                codes = {}
                for n in names:
                    planes, dictionary = colargs[n]
                    if n in value_cols:
                        cols[n] = self._decode_in_trace(n, planes, dictionary)
                    if n in pcols or n == key:
                        codes[n] = self._decode_in_trace(
                            n, planes, None, with_dict=False
                        )
                m = self.mask_tiled()
                for vp in vplanes:
                    m = m & (_unpack_plane_tiled(vp, 1) != 0)
                m = self._predicate_mask_in_trace(
                    pcols, flags, codes, los, his, m
                )
                # dict keys group by CODE (dense by construction); plain
                # int keys group by value
                kv = codes[key].astype(jnp.int32)
                k = jnp.where(m, kv, num_groups)
                outs = []
                for v in values:
                    vv = cols[v]
                    if not jnp.issubdtype(vv.dtype, jnp.floating):
                        vv = vv.astype(jnp.int64)
                    outs.append(
                        jax.ops.segment_sum(
                            jnp.where(m, vv, 0), k, num_segments=num_groups + 1
                        )[:num_groups]
                    )
                cnt = jax.ops.segment_sum(
                    m.astype(jnp.int64), k, num_segments=num_groups + 1
                )[:num_groups]
                return outs, cnt

            fn = jax.jit(impl)
            self._jit_cache[ck] = fn
        colargs = {n: self._col_args(n) for n in names}
        vplanes = tuple(
            self.columns[n].validity_plane
            for n in names
            if self.columns[n].validity_plane is not None
        )
        los, his = self._bound_scalars(predicates, pcols)
        return fn(colargs, vplanes, los, his)


# ---------------------------------------------------------------------------
# Loader: host-decode (complete format coverage) → plane re-encode.
# ---------------------------------------------------------------------------


_DEVICE_PACK_MIN = 1 << 16  # below this the host pack beats jit dispatch


def _pack_plane(vals: np.ndarray, bits: int, tile: int):
    """(n,) uint32 values (< 2^bits) → (n_tiles, bits, tile) device words,
    PRE-PERMUTED so the tiled unpack emits natural row order directly.

    Large columns transfer the raw u32 values and pack ON DEVICE
    (``_pack_plane_device`` — the bit-level inverse of the unpack kernel,
    pure VPU shifts/ors): the host-side feed permutation + pack_blocks +
    word transpose were the dominant cost of resident loads.  Small
    columns keep the host pack (jit dispatch would dominate)."""
    import jax.numpy as jnp

    from ..util.bits import pack_blocks

    assert tile % 512 == 0, "tile must be a LANE_TILE multiple"
    bits = max(bits, 1)
    if len(vals) >= _DEVICE_PACK_MIN:
        return _pack_plane_device(
            jnp.asarray(np.ascontiguousarray(vals, dtype=np.uint32)),
            bits,
            tile,
        )
    n = max(len(vals), 1)
    lanes = (-(-n // 128)) * 4  # blocks * 4
    lanes_final = -(-lanes // tile) * tile
    slots = lanes_final * 32
    n_tiles = lanes_final // tile
    padded = (
        vals
        if len(vals) == slots
        else np.concatenate([vals, np.zeros(slots - len(vals), np.uint32)])
    )
    # output slot s reads pack-input position src(s); want output[s] = row s.
    # The inverse permutation is a pure reshape/transpose (no scatter):
    # feed[ti, B, t, l] = tm[ti, t, 4B + l] where tm = rows in slot order
    feed = np.ascontiguousarray(
        padded.reshape(n_tiles, 32, tile // 4, 4).transpose(0, 2, 1, 3)
    ).reshape(-1)
    words = pack_blocks(feed.reshape(-1, 128), bits)
    return jnp.asarray(transpose_words_host_tiled(words.reshape(-1), bits, tile))


def _split_planes(u: np.ndarray, total_bits: int, tile: int):
    """u64 payloads → 1–2 packed ≤32-bit planes (LSB first)."""
    if total_bits <= 32:
        return (
            ((_pack_plane(u.astype(np.uint32), total_bits, tile), max(total_bits, 1)),),
            (0,),
        )
    lo = (u & np.uint64(0xFFFFFFFF)).astype(np.uint32)
    hi = (u >> np.uint64(32)).astype(np.uint32)
    return (
        (_pack_plane(lo, 32, tile), 32),
        (_pack_plane(hi, total_bits - 32, tile), total_bits - 32),
    ), (0, 32)


def _try_dict(vals: np.ndarray):
    """Sorted-unique dictionary + codes, or None when cardinality is high.

    A cheap strided sample gates the full pass so high-cardinality columns
    don't pay a wasted full scan just to be told 'no'.  The pass itself is
    the C first-occurrence intern (one O(n) open-addressing sweep over the
    bit patterns) + an O(u log u) sort of the small unique set — replacing
    ``np.unique(return_inverse=True)``'s full O(n log n) sort, which
    dominated SF10 resident loads.
    """
    n = len(vals)
    if n == 0:
        return None
    if n > (1 << 17):
        sample = vals[:: max(1, n // 65536)]
        if np.unique(sample).size > (1 << 14):
            return None
    if vals.dtype.itemsize in (4, 8) and n >= 4096:
        from .. import native

        if native.available():
            kind = np.uint32 if vals.dtype.itemsize == 4 else np.uint64
            r = native.factorize(
                np.ascontiguousarray(vals).view(kind), max_uniq=_MAX_DICT
            )
            if r is None:
                return None  # unique count exceeded _MAX_DICT mid-pass
            codes_f, uniq_bits = r
            uniq = uniq_bits.view(vals.dtype)
            order = np.argsort(uniq, kind="stable")
            rank = np.empty(len(order), dtype=np.uint32)
            rank[order.astype(np.intp)] = np.arange(
                len(order), dtype=np.uint32
            )
            return uniq[order], rank[codes_f]
    uniq, inv = np.unique(vals, return_inverse=True)
    if uniq.size > _MAX_DICT:
        return None
    return uniq, inv.astype(np.uint32)


def _try_dict_int(vals: np.ndarray, vmin: int, vmax: int):
    """Integer dictionary without the O(n log n) sort when the value SPAN is
    small: presence bitmap over [vmin, vmax] + rank table — one O(n) pass
    (np.unique's sort + return_inverse cumsum dominate resident load time
    otherwise)."""
    span = vmax - vmin
    if len(vals) == 0:
        return None
    if span >= (1 << 24):  # rank table would outweigh the win
        return _try_dict(vals)
    offs = (vals - np.int64(vmin)).astype(np.int64)
    presence = np.zeros(span + 1, dtype=bool)
    presence[offs] = True
    uniq_off = np.flatnonzero(presence)
    if uniq_off.size > _MAX_DICT:
        return None
    rank = np.empty(span + 1, dtype=np.uint32)
    rank[uniq_off] = np.arange(uniq_off.size, dtype=np.uint32)
    return (uniq_off + vmin).astype(np.int64), rank[offs]


def _bits_of(x: int) -> int:
    return max(int(x).bit_length(), 1)


def _encode_int(name, vals: np.ndarray, tile: int, arrow_type, rows):
    """int64 values → dict codes or offset-stripped planes."""
    import jax.numpy as jnp

    if len(vals):
        vmin, vmax = int(vals.min()), int(vals.max())
    else:
        vmin = vmax = 0
    span_bits = _bits_of(vmax - vmin)  # python ints: no wrap
    offset = 0 if vmin >= 0 and vmax < (1 << 31) else vmin
    plain_bits = span_bits if offset else _bits_of(vmax)
    wide = arrow_type is not None and (
        (pa.types.is_integer(arrow_type) and arrow_type.bit_width == 64)
        or pa.types.is_timestamp(arrow_type)
        or pa.types.is_date64(arrow_type)
        or pa.types.is_time64(arrow_type)
        or pa.types.is_decimal(arrow_type)
    )
    d = _try_dict_int(vals, vmin, vmax)
    if d is not None:
        uniq, codes = d
        code_bits = _bits_of(max(len(uniq) - 1, 1))
        # beyond the one-hot matmul range (kernels/gather.MAX_MXU_TABLE) a
        # value decode pays a plain XLA gather — only keep the dictionary
        # when the packed saving is decisive (>= 2x; the H100 cut-over is
        # ROADMAP D4)
        if len(uniq) > 8192 and code_bits * 2 > plain_bits:
            d = None
        elif code_bits < plain_bits:
            fits32 = vmin >= -(1 << 31) and vmax < (1 << 31)
            dev = jnp.asarray(
                uniq.astype(np.int32) if fits32 and not wide else uniq
            )
            planes, shifts = _split_planes(
                codes.astype(np.uint64), code_bits, tile
            )
            return ResidentColumn(
                name, planes, shifts, rows, "int",
                wide=wide,
                dictionary=dev,
                dictionary_host=uniq.astype(np.int64),
                arrow_type=arrow_type,
            )
    u = vals.astype(np.uint64) - np.uint64(np.int64(offset).astype(np.uint64))
    planes, shifts = _split_planes(u, plain_bits, tile)
    return ResidentColumn(
        name, planes, shifts, rows, "int",
        wide=wide,
        offset=int(np.int64(offset).astype(np.uint64)),
        arrow_type=arrow_type,
    )


def _encode_float(name, vals: np.ndarray, tile: int, arrow_type, rows):
    """f32/f64 → dict codes or trailing-zero-stripped offset bitcast planes."""
    import jax.numpy as jnp

    is32 = vals.dtype == np.float32
    kind = "f32" if is32 else "f64"
    udt = np.uint32 if is32 else np.uint64
    width = 32 if is32 else 64
    u = vals.view(udt)
    if len(u):
        orv = int(np.bitwise_or.reduce(u))
        tz = (orv & -orv).bit_length() - 1 if orv else 0
        us = u >> udt(tz)
        off = int(us.min())
        us = us - udt(off)
        bits = _bits_of(int(us.max())) if us.max() else 1
    else:
        tz, off, bits = 0, 0, 1
        us = u
    # the dict path is value-space: NaN breaks it twice (np.unique collapses
    # distinct NaN payloads; code-space predicates put NaN ABOVE every bound,
    # so `v >= lo` would match) and mixed ±0.0 loses the sign bit.  The plane
    # path is bitcast-exact for all of them — fall through to it.
    has_nan = bool(np.isnan(vals).any()) if len(vals) else False
    zeros = vals == 0
    mixed_zero = bool(
        zeros.any()
        and np.signbit(vals[zeros]).any()
        and not np.signbit(vals[zeros]).all()
    )
    d = None if has_nan or mixed_zero else _try_dict(vals)
    if d is not None:
        uniq, codes = d
        code_bits = _bits_of(max(len(uniq) - 1, 1))
        # worthwhile iff codes beat the stripped bit pattern; beyond the
        # one-hot matmul range a value decode pays a plain XLA gather —
        # only keep a big dictionary when the saving is decisive (>= 2x)
        if code_bits < bits and (
            len(uniq) <= 8192 or code_bits * 2 <= bits
        ):
            planes, shifts = _split_planes(
                codes.astype(np.uint64), code_bits, tile
            )
            return ResidentColumn(
                name, planes, shifts, rows, kind,
                dictionary=jnp.asarray(uniq),
                dictionary_host=uniq.astype(np.float64) if is32 else uniq,
                arrow_type=arrow_type,
            )
    planes, shifts = _split_planes(us.astype(np.uint64), bits, tile)
    return ResidentColumn(
        name, planes, shifts, rows, kind,
        offset=off, bit_shift=tz, arrow_type=arrow_type,
    )


def _encode_string(name, arr: pa.Array, tile: int, arrow_type, rows):
    """utf8/binary → packed codes + GLOBAL SORTED dictionary."""
    import pyarrow.compute as pc

    denc = arr.dictionary_encode()
    if isinstance(denc, pa.ChunkedArray):
        denc = denc.combine_chunks()
    d = denc.dictionary
    if len(d) > _MAX_DICT:
        raise NotYetImplementedError(
            f"resident load: string column {name!r} has {len(d)} distinct "
            f"values (> {_MAX_DICT})"
        )
    order = pc.sort_indices(d).to_numpy(zero_copy_only=False)
    rank = np.empty(max(len(d), 1), dtype=np.uint32)
    rank[order] = np.arange(len(order), dtype=np.uint32)
    indices = denc.indices
    if indices.null_count:
        # null indices must not round-trip through float NaN (undefined
        # int cast); pin them to code 0 — the validity plane masks them
        indices = indices.fill_null(0)
    codes_raw = indices.to_numpy(zero_copy_only=False).astype(np.int64)
    codes = rank[codes_raw] if len(d) else np.zeros(rows, dtype=np.uint32)
    sorted_pa = d.take(pa.array(order)) if len(d) else d
    code_bits = _bits_of(max(len(d) - 1, 1))
    planes, shifts = _split_planes(codes.astype(np.uint64), code_bits, tile)
    return ResidentColumn(
        name, planes, shifts, rows, "str",
        dictionary_host=np.asarray(sorted_pa.to_pandas(), dtype=object),
        dictionary_pa=sorted_pa,
        arrow_type=arrow_type,
    )


def _encode_resident_column(
    field: pa.Field, arr: pa.ChunkedArray, tile: int
) -> ResidentColumn:
    arr = arr.combine_chunks() if isinstance(arr, pa.ChunkedArray) else arr
    rows = len(arr)
    t = field.type
    validity = None
    if arr.null_count:
        validity = ~np.asarray(arr.is_null())
    if pa.types.is_string(t) or pa.types.is_binary(t) or pa.types.is_large_string(t) or pa.types.is_large_binary(t):
        col = _encode_string(field.name, arr, tile, t, rows)
    elif pa.types.is_boolean(t):
        arr_f = arr.fill_null(False) if arr.null_count else arr
        v01 = arr_f.to_numpy(zero_copy_only=False).astype(np.uint32)
        planes = ((_pack_plane(v01, 1, tile), 1),)
        col = ResidentColumn(field.name, planes, (0,), rows, "bool", arrow_type=t)
    elif pa.types.is_floating(t):
        if t.bit_width == 16:
            raise NotYetImplementedError("resident load of float16")
        # read raw bit patterns from the VALUES buffer: genuine NaN / ±inf /
        # -0.0 at non-null positions survive bit-exactly (`to_numpy` turns
        # nulls into NaN, making them indistinguishable from real NaNs —
        # the r4 silent-zeroing bug).  Null slots hold arbitrary bits, so
        # neutralize them with a valid value to keep plane stats tight.
        npdt = np.dtype(np.float32 if t.bit_width == 32 else np.float64)
        buf = arr.buffers()[1]
        if buf is None:  # all-null arrays may carry no values buffer
            vals = np.zeros(len(arr), dtype=npdt)
        else:
            vals = np.frombuffer(
                buf, dtype=npdt, count=len(arr) + arr.offset
            )[arr.offset :].copy()
        if validity is not None:
            valid_idx = np.flatnonzero(validity)
            fill = vals[valid_idx[0]] if valid_idx.size else npdt.type(0)
            vals[~validity] = fill
        col = _encode_float(field.name, np.ascontiguousarray(vals), tile, t, rows)
    elif (
        pa.types.is_integer(t)
        or pa.types.is_date(t)
        or pa.types.is_timestamp(t)
        or pa.types.is_time(t)
    ):
        if arr.null_count:
            arr_f = arr.fill_null(0)
        else:
            arr_f = arr
        vals = np.ascontiguousarray(
            arr_f.to_numpy(zero_copy_only=False).astype(np.int64)
        )
        col = _encode_int(field.name, vals, tile, t, rows)
    elif pa.types.is_decimal(t) and t.bit_width == 128 and t.precision <= 18:
        # unscaled int64 domain — the same device representation the scan
        # layer uses (predicates on decimals compare unscaled ints)
        limbs = np.frombuffer(
            arr.buffers()[1], dtype="<i8",
            count=2 * (len(arr) + arr.offset),
        ).reshape(-1, 2)[arr.offset : arr.offset + len(arr)]
        lo, hi = limbs[:, 0].copy(), limbs[:, 1]
        if validity is not None:
            lo[~validity] = 0
            ok = (hi == (lo >> 63)) | ~validity
        else:
            ok = hi == (lo >> 63)
        if not bool(np.all(ok)):
            raise OutOfSpecError(
                f"decimal column {field.name!r}: unscaled value exceeds "
                f"int64 despite precision {t.precision}"
            )
        col = _encode_int(field.name, np.ascontiguousarray(lo), tile, t, rows)
    elif pa.types.is_list(t) or pa.types.is_large_list(t):
        import pyarrow.compute as pc

        # lengths plane on the row grid (composed row→leaf counts; null
        # rows canonicalize to length 0), flattened leaves as a child
        # ResidentColumn over their own grid.  Depth recurses: a
        # list<list<…>> child is itself a 'list' column.
        # Ref semantics: /root/reference/src/read/batch_read.rs:66-187.
        lengths = pc.list_value_length(arr)
        if lengths.null_count:
            lengths = lengths.fill_null(0)
        ln = np.asarray(lengths).astype(np.int64)
        child_arr = pc.list_flatten(arr)
        child_field = pa.field(
            f"{field.name}.item", t.value_type, nullable=True
        )
        child = _encode_resident_column(child_field, child_arr, tile)
        bits = _bits_of(int(ln.max())) if len(ln) and ln.max() else 1
        planes, shifts = _split_planes(ln.astype(np.uint64), bits, tile)
        col = ResidentColumn(
            field.name, planes, shifts, rows, "list",
            arrow_type=t, child=child,
        )
    elif pa.types.is_map(t):
        # map = list<struct<key, value>>: lengths plane on the row grid,
        # keys/items as a struct child over the ENTRY grid.  Null rows
        # have repeated offsets (length 0); MapArray.from_arrays + mask
        # rebuilds exactly.
        offs = np.asarray(arr.offsets.fill_null(0)).astype(np.int64) \
            if arr.offsets.null_count else np.asarray(arr.offsets).astype(np.int64)
        ln = np.diff(offs)
        keys = arr.keys
        items = arr.items
        if len(offs) and int(offs[0]):  # sliced window: rebase children
            keys = keys.slice(int(offs[0]), int(offs[-1] - offs[0]))
            items = items.slice(int(offs[0]), int(offs[-1] - offs[0]))
        ent_type = pa.struct(
            [pa.field("key", t.key_type, nullable=False),
             pa.field("value", t.item_type)]
        )
        children = {
            "key": _encode_resident_column(
                pa.field(f"{field.name}.key", t.key_type, nullable=True),
                keys, tile,
            ),
            "value": _encode_resident_column(
                pa.field(f"{field.name}.value", t.item_type, nullable=True),
                items, tile,
            ),
        }
        ent = ResidentColumn(
            f"{field.name}.entries", (), (), len(keys), "struct",
            arrow_type=ent_type, children=children,
        )
        bits = _bits_of(int(ln.max())) if len(ln) and ln.max() else 1
        planes, shifts = _split_planes(ln.astype(np.uint64), bits, tile)
        col = ResidentColumn(
            field.name, planes, shifts, rows, "list",
            arrow_type=t, child=ent,
        )
    elif pa.types.is_struct(t):
        # unnest to per-field columns on the SAME row grid (the scan
        # layer's `parent.field` convention); parent nullability rides as
        # this column's validity plane, children keep their own.
        children = {}
        for i in range(t.num_fields):
            sub = t.field(i)
            children[sub.name] = _encode_resident_column(
                pa.field(f"{field.name}.{sub.name}", sub.type, nullable=True),
                arr.field(i),
                tile,
            )
        col = ResidentColumn(
            field.name, (), (), rows, "struct", arrow_type=t,
            children=children,
        )
    else:
        raise NotYetImplementedError(
            f"resident load of column {field.name!r} type {t}"
        )
    if validity is not None:
        col.validity_plane = _pack_plane(validity.astype(np.uint32), 1, tile)
    return col


# ---------------------------------------------------------------------------
# Device-direct encode: DeviceTable (scan/shuffle/join result on device) →
# planes, without a to_arrow host roundtrip.  The pack permutation is
# algebraic (tiled slot s == natural row s), so packing is pure
# shifts/ors over a reshape — no gather, no scatter, no host round trip.
# ---------------------------------------------------------------------------

_DEV_PACK_CACHE: Dict[Any, Any] = {}


def _slots_for(n: int, tile: int) -> int:
    """Tiled slot count for n rows — matches ``_pack_plane``'s padding."""
    lanes = (-(-max(n, 1) // 128)) * 4
    lanes_final = -(-lanes // tile) * tile
    return lanes_final * 32


def _pack_plane_device(vals, bits: int, tile: int):
    """(n,) u32 DEVICE values in natural row order (< 2^bits) →
    (n_tiles, bits, tile) packed words — the bit-level inverse of
    ``_unpack_plane_tiled``: plain shifts and ors.
    """
    import jax
    import jax.numpy as jnp

    b = max(bits, 1)
    n = int(vals.shape[0])
    slots = _slots_for(n, tile)
    if n < slots:
        vals = jnp.concatenate(
            [vals, jnp.zeros(slots - n, dtype=jnp.uint32)]
        )
    fn = _DEV_PACK_CACHE.get((b, tile))
    if fn is None:

        def impl(v, _b=b):
            s_ = v.shape[0]
            v3 = v.reshape(s_ // (32 * tile), 32, tile)
            if 32 % _b == 0:
                P = 32 // _b
                nt = v3.shape[0]
                # value t = j*P + p lives in word j at bit offset p*b
                v4 = v3.reshape(nt, _b, P, tile)
                w = v4[:, :, 0, :]
                for p in range(1, P):
                    w = w | (v4[:, :, p, :] << jnp.uint32(p * _b))
                return w
            # general widths: value t's bits occupy [t*b, (t+1)*b) of the
            # lane's little-endian word stream (may straddle two words)
            words = [None] * _b
            for t in range(32):
                s0 = t * _b
                w0, sh = s0 // 32, s0 % 32
                v_t = v3[:, t, :]
                lo = (v_t << jnp.uint32(sh)) if sh else v_t
                words[w0] = lo if words[w0] is None else (words[w0] | lo)
                if sh + _b > 32:
                    hi = v_t >> jnp.uint32(32 - sh)
                    words[w0 + 1] = (
                        hi if words[w0 + 1] is None else (words[w0 + 1] | hi)
                    )
            return jnp.stack(words, axis=1)

        fn = jax.jit(impl)
        _DEV_PACK_CACHE[(b, tile)] = fn
    return fn(vals)


def _split_planes_device(lo, hi, total_bits: int, tile: int):
    """Device u32 lo/hi words → 1–2 packed planes (LSB first)."""
    if total_bits <= 32:
        return (
            (_pack_plane_device(lo, total_bits, tile), max(total_bits, 1)),
        ), (0,)
    return (
        (_pack_plane_device(lo, 32, tile), 32),
        (_pack_plane_device(hi, total_bits - 32, tile), total_bits - 32),
    ), (0, 32)


def _dev_fn(key: str, builder):
    """Module-cached jitted helper — compiled once per (key, shape) rather
    than once per encode call; variable scalars (offsets, bounds) ride as
    TRACED arguments so changing them never recompiles."""
    fn = _DEV_PACK_CACHE.get(key)
    if fn is None:
        import jax

        fn = jax.jit(builder)
        _DEV_PACK_CACHE[key] = fn
    return fn


def _encode_int_device(c, tile: int, rows: int) -> ResidentColumn:
    import jax
    import jax.numpy as jnp

    v = c.values[:rows].astype(jnp.int64)
    validity = None if c.validity is None else c.validity[:rows]

    def stats_m(v, m):
        big = jnp.iinfo(jnp.int64).max
        return (
            jnp.min(jnp.where(m, v, big)),
            jnp.max(jnp.where(m, v, -big - 1)),
        )

    if rows:
        if validity is None:
            fn = _dev_fn("int_stats", lambda v: (jnp.min(v), jnp.max(v)))
            vmin, vmax = (int(x) for x in jax.device_get(fn(v)))
        else:
            fn = _dev_fn("int_stats_m", stats_m)
            vmin, vmax = (int(x) for x in jax.device_get(fn(v, validity)))
            if vmin > vmax:  # all null
                vmin = vmax = 0
    else:
        vmin = vmax = 0
    span_bits = _bits_of(vmax - vmin)
    offset = 0 if vmin >= 0 and vmax < (1 << 31) else vmin
    plain_bits = span_bits if offset else _bits_of(vmax)
    t = c.dtype
    wide = t is not None and (
        (pa.types.is_integer(t) and t.bit_width == 64)
        or pa.types.is_timestamp(t)
        or pa.types.is_date64(t)
        or pa.types.is_time64(t)
        or pa.types.is_decimal(t)
    )

    def words(v, off):
        u = (v - off).astype(jnp.uint64)
        return (
            (u & jnp.uint64(0xFFFFFFFF)).astype(jnp.uint32),
            (u >> jnp.uint64(32)).astype(jnp.uint32),
        )

    if validity is None:
        lo, hi = _dev_fn("int_words", words)(v, jnp.int64(offset))
    else:
        lo, hi = _dev_fn(
            "int_words_m",
            lambda v, m, off, fill: words(jnp.where(m, v, fill), off),
        )(v, validity, jnp.int64(offset), jnp.int64(vmin))
    planes, shifts = _split_planes_device(lo, hi, plain_bits, tile)
    return ResidentColumn(
        c.name, planes, shifts, rows, "int",
        wide=wide,
        offset=int(np.int64(offset).astype(np.uint64)),
        arrow_type=t,
    )


def _encode_f32_device(c, tile: int, rows: int) -> ResidentColumn:
    import jax
    import jax.numpy as jnp

    v = c.values[:rows]
    validity = None if c.validity is None else c.validity[:rows]

    def bits(v):
        return jax.lax.bitcast_convert_type(
            v.astype(jnp.float32), jnp.uint32
        )

    if validity is None:
        u = _dev_fn("f32_bits", bits)(v)
    else:
        u = _dev_fn(
            "f32_bits_m",
            lambda v, m: jnp.where(m, bits(v), jnp.uint32(0)),
        )(v, validity)
    planes, shifts = _split_planes_device(u, u, 32, tile)
    return ResidentColumn(
        c.name, planes, shifts, rows, "f32", arrow_type=c.dtype
    )


def _encode_dictcol_device(c, tile: int, rows: int) -> ResidentColumn:
    """String/binary DeviceColumn (codes + host pa dictionary) → packed
    codes over the GLOBAL SORTED dictionary (code remap rides the device:
    one-hot matmul for small dictionaries, one XLA gather otherwise — a
    one-time load cost, never a per-query one)."""
    import jax
    import jax.numpy as jnp
    import pyarrow.compute as pc

    from ..kernels.decode import dict_gather_device

    d = c.dictionary
    if len(d) > _MAX_DICT:
        raise NotYetImplementedError(
            f"resident encode: column {c.name!r} dictionary too large"
        )
    order = pc.sort_indices(d).to_numpy(zero_copy_only=False)
    rank = np.empty(max(len(d), 1), dtype=np.int32)
    rank[order.astype(np.intp)] = np.arange(len(order), dtype=np.int32)
    sorted_pa = d.take(pa.array(order)) if len(d) else d
    codes = c.values[:rows].astype(jnp.int32)
    validity = None if c.validity is None else c.validity[:rows]

    def remap(codes, rank_dev, cmax):
        cc = jnp.clip(codes, 0, cmax)
        return dict_gather_device(cc, rank_dev).astype(jnp.uint32)

    cmax = jnp.int32(max(len(d) - 1, 0))
    if validity is None:
        new_codes = _dev_fn("dict_remap", remap)(codes, jnp.asarray(rank), cmax)
    else:
        new_codes = _dev_fn(
            "dict_remap_m",
            lambda codes, m, rank_dev, cmax: remap(
                jnp.where(m, codes, 0), rank_dev, cmax
            ),
        )(codes, validity, jnp.asarray(rank), cmax)
    code_bits = _bits_of(max(len(d) - 1, 1))
    planes, shifts = _split_planes_device(new_codes, new_codes, code_bits, tile)
    return ResidentColumn(
        c.name, planes, shifts, rows, "str",
        dictionary_host=np.asarray(sorted_pa.to_pandas(), dtype=object),
        dictionary_pa=sorted_pa,
        arrow_type=c.dtype,
    )


def _encode_device_column(c, tile: int, rows: int) -> ResidentColumn:
    import jax.numpy as jnp

    if getattr(c, "offsets", None) is not None:
        raise NotYetImplementedError(
            f"device-direct resident encode of nested column {c.name!r}"
        )
    t = c.dtype
    if c.dictionary is not None:
        col = _encode_dictcol_device(c, tile, rows)
    elif t is not None and pa.types.is_boolean(t):
        v = c.values[:rows]
        if c.validity is not None:
            v = v & c.validity[:rows]
        col = _encode_resident_bool_device(c.name, v, tile, t, rows)
    elif c.values.dtype == jnp.float64:
        # the exact bytes live host-side in ``host_exact`` (ROADMAP D5).
        # Encode those when present (bit-exact); otherwise the device values
        # ARE the data.
        if c.host_exact is not None:
            vals = np.ascontiguousarray(c.host_exact[:rows])
            col = _encode_float(c.name, vals, tile, t, rows)
        else:
            vals = np.ascontiguousarray(
                np.asarray(c.values[:rows], dtype=np.float64)
            )
            if c.validity is not None:
                ok = np.asarray(c.validity[:rows])
                if not ok.all():
                    vi = np.flatnonzero(ok)
                    vals[~ok] = vals[vi[0]] if vi.size else 0.0
            col = _encode_float(c.name, vals, tile, t, rows)
    elif c.values.dtype == jnp.float32:
        col = _encode_f32_device(c, tile, rows)
    elif jnp.issubdtype(c.values.dtype, jnp.integer) or (
        t is not None
        and (
            pa.types.is_integer(t)
            or pa.types.is_date(t)
            or pa.types.is_timestamp(t)
            or pa.types.is_time(t)
            or pa.types.is_decimal(t)
        )
    ):
        col = _encode_int_device(c, tile, rows)
    else:
        raise NotYetImplementedError(
            f"device-direct resident encode of column {c.name!r} "
            f"dtype {c.values.dtype}/{t}"
        )
    if c.validity is not None:
        v01 = c.validity[:rows].astype(jnp.uint32)
        col.validity_plane = _pack_plane_device(v01, 1, tile)
    return col


def _encode_resident_bool_device(name, v, tile, t, rows) -> ResidentColumn:
    import jax.numpy as jnp

    planes = ((_pack_plane_device(v.astype(jnp.uint32), 1, tile), 1),)
    return ResidentColumn(name, planes, (0,), rows, "bool", arrow_type=t)


def _make_resident_device(dt, tile: int) -> ResidentTable:
    out: Dict[str, ResidentColumn] = {}
    rows = int(dt.num_rows)
    for name, c in dt.columns.items():
        out[name] = _encode_device_column(c, tile, rows)
    if not out:
        raise OutOfSpecError("no loadable columns")
    return ResidentTable(out, rows, tile)


def make_resident(table, tile: Optional[int] = None) -> ResidentTable:
    """Build a resident table directly from a ``pa.Table`` or DeviceTable
    (e.g. a scan/shuffle/join result) — the serving handoff without a file
    roundtrip.  DeviceTables encode DEVICE-DIRECT: planes are packed on the
    device by the bit-level inverse of the plane unpack (no ``to_arrow``,
    no host round trip) — except exact-f64 columns, whose bit-exact bytes live
    host-side by design.  Falls back to the host path for layouts the
    device encoder does not cover (nested)."""
    tile = tile or TILE3D
    if not isinstance(table, pa.Table):
        try:
            return _make_resident_device(table, tile)
        except NotYetImplementedError:
            table = table.to_arrow()
    table = table.combine_chunks()
    fields = list(table.schema)
    if len(fields) > 1:
        # per-column encodes are numpy/arrow-C++ heavy (GIL-released hot
        # loops) — thread them like read_table threads its columns
        import concurrent.futures as cf
        import os as _os

        with cf.ThreadPoolExecutor(
            max_workers=min(len(fields), _os.cpu_count() or 2)
        ) as pool:
            encoded = list(
                pool.map(
                    lambda f: _encode_resident_column(
                        f, table.column(f.name), tile
                    ),
                    fields,
                )
            )
    else:
        encoded = [
            _encode_resident_column(f, table.column(f.name), tile)
            for f in fields
        ]
    out: Dict[str, ResidentColumn] = {}
    struct_specs: Dict[str, Any] = {}
    order = []
    n_rows = None
    slots = None

    def _admit(name, col):
        nonlocal n_rows, slots
        if n_rows is None:
            n_rows, slots = col.length, col.tiled_slots
        elif col.length != n_rows or col.tiled_slots != slots:
            raise OutOfSpecError(
                f"resident columns disagree on row grid: {name!r}"
            )
        out[name] = col

    def _admit_col(name, col):
        if col.kind == "struct":
            names = []
            for sub, ccol in col.children.items():
                cname = f"{name}.{sub}"
                _admit_col(cname, ccol)  # struct<struct<…>> recurses
                names.append((sub, cname))
            struct_specs[name] = (
                tuple(names), col.validity_plane, col.arrow_type,
            )
        else:
            _admit(name, col)

    for field, col in zip(fields, encoded):
        order.append(field.name)
        _admit_col(field.name, col)
    if not out:
        raise OutOfSpecError("no loadable columns")
    return ResidentTable(
        out, n_rows, tile,
        struct_specs=struct_specs or None,
        field_order=order,
    )


def load_resident(
    path,
    columns: Optional[Sequence[str]] = None,
    tile: Optional[int] = None,
) -> ResidentTable:
    """Load a file's (or multi-file dataset's) columns as a
    resident table of packed planes in device memory.

    ``path``: one file path, a glob pattern, or an explicit list of parts
    (parts concatenate host-side before plane encoding — the resident
    analogue of ``scan_dataset``).  Decodes through the complete host read
    path (every page codec the format produces — the chooser's full
    matrix, tail pages, mixed dict/plain columns) and re-encodes into
    packed planes; device memory cost is bits/32 of the decoded size per column plus
    KB-scale dictionaries.  List columns (any depth, incl. list<utf8>)
    load as a lengths plane + child planes and serve ``list_sum`` /
    ``to_arrow``.  Unsupported TYPES (struct/map, wide decimal, float16)
    raise — resident loading is an opt-in fast representation, never
    silently wrong.
    """
    from ..api import read_table

    tile = tile or TILE3D
    want = list(columns) if columns else None
    if isinstance(path, str) and not any(ch in path for ch in "*?["):
        table = read_table(path, columns=want)
    else:
        from .dataset import resolve_paths

        parts = [read_table(p, columns=want) for p in resolve_paths(path)]
        table = pa.concat_tables(parts)
    if want is not None:
        table = table.select([n for n in want if n in table.schema.names])
    return make_resident(table, tile=tile)
