"""Device-table writer: codec selection from device-resident stats.

SURVEY §7 step 3 — the post-shuffle re-encode case.  The reference writer's
two hot loops are a per-page host stats scan (integer/mod.rs:179-229) and
sampled trial compression (integer/mod.rs:231-347).  Here loop 1 runs as ONE
batched device reduction over every page of a column
(:func:`..kernels.encode.paged_stats_device` — masked min/max, run counts,
sortedness, hashed distinct estimate), and the codec chooser consumes those
scalars; only the chosen codec's byte serialization runs on the host, over
values fetched once per column.

Dictionary-coded string columns never materialize row strings: each page
emits a Dict page body (reference binary/dict.rs:55-141 layout) directly
from the device codes + the host dictionary.

Notes vs the host writer:
- FREQ: device stats carry a distinct *estimate* only, but when the estimate
  is tiny (≤16) the already-materialized host bytes yield the exact mode via
  one ``np.unique`` — re-enabling FREQ for the pages where it can win.  Any
  codec choice is format-legal — roundtrip equality, not byte-parity with
  the host writer, is the contract.
- boolean columns pack to bitmap bytes ON DEVICE (8× smaller download) when
  the page grid is byte-aligned; raw pages slice the packed stream with no
  per-row host work.  Non-byte-aligned grids fall back to the host encoder.
- list columns re-encode through the host Dremel machinery over the
  device-fetched offsets (nested preludes + leaf pages, write/nested.py) —
  the value bytes still come from the device scan.
- in-band zone maps are emitted exactly like the host writer
  (``zone_maps=True``): numerics from the device stats reduction, booleans
  from device counts, decimals over the unscaled int64 domain.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import pyarrow as pa

from ..codecs import WriteOptions, common, write_header
from ..codecs._family import FamilyStats
from ..codecs import integer as integer_codec
from ..codecs import double as double_codec
from ..constants import Compression
from ..errors import NotYetImplementedError
from ..kernels.encode import paged_stats_device
from ..meta import ColumnMeta, PageMeta
from .serialize import _validity_prelude
from .writer import NativeWriter, _STATE_WRITTEN


def _family_stats_from_device(
    page_vals: np.ndarray,
    page_validity: Optional[np.ndarray],
    d: dict,
    i: int,
) -> FamilyStats:
    n = len(page_vals)
    dtype = page_vals.dtype
    null_count = int(d["null_count"][i])
    set_count = int(d["set_count"][i])
    run_count = int(d["run_count"][i])
    vmin = dtype.type(d["min"][i])
    vmax = dtype.type(d["max"][i])
    if set_count == 0:
        unique = 0
    elif vmin == vmax:
        unique = 1 if null_count == 0 else 2
    else:
        unique = max(2, int(d["unique_est"][i]))
    return FamilyStats(
        values=page_vals,
        validity=page_validity,
        tuple_count=n,
        total_bytes=n * dtype.itemsize,
        null_count=null_count,
        average_run_length=(n / run_count) if run_count else float("inf"),
        is_sorted=bool(d["is_sorted"][i]),
        min=vmin,
        max=vmax,
        unique_count=unique,
        top_value=vmin,  # FREQ disabled: estimate-only stats have no mode
        max_count=0,
        set_count=set_count,
    )


def _encode_numeric_page(
    vals: np.ndarray,
    validity: Optional[np.ndarray],
    stats: FamilyStats,
    options: WriteOptions,
    allow_freq: bool = False,
) -> bytes:
    mod = double_codec if vals.dtype.kind == "f" else integer_codec
    opts = options if allow_freq else options.forbid(Compression.FREQ)
    codec = mod.choose_compressor(stats, opts)
    if codec.raw_mode:
        body = common.compress(
            codec, vals.astype(vals.dtype.newbyteorder("<"), copy=False).tobytes()
        )
    else:
        body = mod._codec_compress(codec, vals, validity, stats, opts)
    return write_header(codec, len(body), len(vals) * vals.dtype.itemsize) + body


def _encode_dict_string_page(
    codes: np.ndarray,
    validity: Optional[np.ndarray],
    dict_offsets: np.ndarray,
    dict_values: np.ndarray,
    options: WriteOptions,
) -> bytes:
    """Dict page body straight from codes: [indices page][u32 n][sets]."""
    uniq, inv = np.unique(codes, return_inverse=True)
    body = bytearray()
    body += integer_codec.compress_integer(
        inv.astype(np.uint32), None, options.forbid(Compression.DICT)
    )
    body += np.uint32(len(uniq)).tobytes()
    total_set_bytes = 0
    for u in uniq:
        s, e = int(dict_offsets[u]), int(dict_offsets[u + 1])
        body += np.uint64(e - s).tobytes()
        body += dict_values[s:e].tobytes()
        total_set_bytes += e - s
    # uncompressed_size for binary pages = the row value bytes
    lens = np.diff(dict_offsets)[codes]
    return (
        write_header(Compression.DICT, len(body), int(lens.sum()))
        + bytes(body)
    )


def _encode_bool_pages_device(col, field, np_validity, n, page_size, options):
    """Boolean pages from a device-packed bitmap (page_size % 8 == 0).

    Codec choice per page from device counts: OneValue when one distinct
    valid value, RLE when the EXACT run-encoded size (run_count × 5B) beats
    the ratio bar — a stronger criterion than the host's sampled estimate
    (divergence is format-legal; bytes decode identically) — else the raw
    bitmap slice through the common codec.
    """
    from ..codecs.boolean import one_value_encode, rle_bool_encode
    from ..codecs import common as common_mod
    from ..kernels.encode import paged_bool_stats_device
    from ..util import env as env_mod
    from ..util.obs import log_codec_choice

    packed_dev, st = paged_bool_stats_device(col.values, col.validity, page_size)
    packed = np.asarray(packed_dev)
    st = {k: np.asarray(v) for k, v in st.items()}
    max_ratio = options.default_compress_ratio
    force_rle = env_mod.check_rle_env()
    for i, off in enumerate(range(0, n, page_size)):
        ln = min(page_size, n - off)
        pv = None if np_validity is None else np_validity[off : off + ln]
        out = bytearray()
        if field.nullable:
            out += _validity_prelude(
                None if pv is None or pv.all() else pv, ln
            )
        true_c = int(st["true_count"][i])
        set_c = int(st["set_count"][i])
        run_c = int(st["run_count"][i])
        nbytes = (ln + 7) // 8
        pslice = packed[off // 8 : off // 8 + nbytes]
        codec = options.default_compression
        if force_rle:
            codec = Compression.RLE
        elif max_ratio is not None:
            if (true_c == 0 or true_c == set_c) and float(ln) > max_ratio:
                codec = Compression.ONE_VALUE
            elif run_c and nbytes / (run_c * 5) > max_ratio:
                codec = Compression.RLE
        log_codec_choice("boolean", codec)
        if codec == Compression.ONE_VALUE:
            vals = np.unpackbits(pslice, bitorder="little")[:ln].astype(bool)
            body = one_value_encode(vals, pv)
        elif codec == Compression.RLE:
            vals = np.unpackbits(pslice, bitorder="little")[:ln].astype(bool)
            body = rle_bool_encode(vals, pv)
        else:
            body = common_mod.compress(codec, pslice.tobytes())
        out += write_header(codec, len(body), ln) + body
        # zone straight from the device counts (no per-row host walk)
        from ..exec.pruning import PageZone

        nulls = int(st["null_count"][i])
        if set_c == 0:
            zone = PageZone(None, None, nulls, ln)
        else:
            zone = PageZone(
                0 if set_c > true_c else 1, 1 if true_c > 0 else 0, nulls, ln
            )
        yield bytes(out), ln, zone


def write_device_table(path_or_file, table, options: WriteOptions = None):
    """Write a DeviceTable to a strawboat file, choosing codecs from
    device-computed page stats.  Returns the column metas.

    Roundtrip contract: ``scan_file(write_device_table(path, t)) == t``
    row-for-row (test: tests/test_device_write.py).
    """
    options = options or WriteOptions()
    page_size = int(options.max_page_size or max(table.num_rows, 1))
    page_size = max(min(page_size, max(table.num_rows, 1)), 1)

    fields = []
    for name, col in table.columns.items():
        dtype = col.dtype
        if dtype is None:
            dtype = pa.from_numpy_dtype(np.asarray(col.values[:1]).dtype)
        fields.append(pa.field(name, dtype, nullable=col.validity is not None))
    schema = pa.schema(fields)

    own = isinstance(path_or_file, str)
    f = open(path_or_file, "wb") if own else path_or_file
    try:
        w = NativeWriter(f, schema, options)
        w.start()
        for (name, col), field in zip(table.columns.items(), schema):
            start = w.offset
            pages = []
            zone_pages = []
            for body, n_rows, zone in _encode_column_pages(
                col, field, page_size, options
            ):
                page_start = w.offset
                w._write(body)
                pages.append(PageMeta(w.offset - page_start, n_rows))
                if zone is not None:
                    zone_pages.append(zone)
            w.metas.append(ColumnMeta(start, pages))
            if options.zone_maps and zone_pages and len(zone_pages) == len(pages):
                from ..exec.pruning import ColumnZones

                w._zones[name] = ColumnZones(name, zone_pages)
        w._state = _STATE_WRITTEN
        w.finish()  # zone trailer rides in-band exactly like the host writer
        return w.metas
    finally:
        if own:
            f.close()


def _page_zone(vals: np.ndarray, pv, ln: int):
    """In-band zone entry for one page (min/max over valid rows)."""
    from ..exec.pruning import PageZone, compute_zones

    mn, mx, nulls = compute_zones(vals, pv)
    return PageZone(mn, mx, nulls, ln)


def _encode_column_pages(col, field, page_size: int, options: WriteOptions):
    """Yield (page_bytes, num_rows, zone|None) for one device column.

    Zones come from the same device-computed page stats that drive codec
    selection (numerics) or a cheap host reduction (decimal/boolean), so a
    device-rewritten file keeps its pruning — the point of the reference's
    stat surface (src/stat.rs:63-152)."""
    np_validity = None if col.validity is None else np.asarray(col.validity)
    n = len(col)
    if n == 0:  # host writer emits zero pages for an empty chunk
        return

    if getattr(col, "offsets", None) is not None:
        # list column: the offsets are already device-resident; rebuild the
        # exact arrow array once and emit nested preludes + leaf pages with
        # the host writer's Dremel machinery (write/nested.py over the
        # fetched offsets — reference serialize.rs:135-232 covers all
        # nesting host-side; the VALUE bytes still came from the device)
        from ..columns import from_arrow
        from ..exec.scan import _list_column_to_arrow
        from .nested import slice_nested, to_nested
        from .serialize import write_page

        arr = _list_column_to_arrow(col)
        host_col = from_arrow(arr)
        pairs = to_nested(host_col, field)
        if len(pairs) != 1:
            raise NotYetImplementedError(
                f"device write of multi-leaf nested column {col.name!r}"
            )
        nests, leaf = pairs[0]
        for off in range(0, n, page_size):
            ln = min(page_size, n - off)
            s_nests, s_leaf = slice_nested(nests, leaf, off, ln)
            body, num_values = write_page(s_nests, s_leaf, options)
            yield body, num_values, None
        return

    is_string = col.dictionary is not None

    if is_string:
        codes = np.asarray(col.values).astype(np.int64)
        d = col.dictionary.cast(pa.large_binary())
        from ..columns import from_arrow

        dcol = from_arrow(d)
        for off in range(0, n, page_size):
            ln = min(page_size, n - off)
            pv = None if np_validity is None else np_validity[off : off + ln]
            out = bytearray()
            if field.nullable:
                out += _validity_prelude(
                    None if pv is None or pv.all() else pv, ln
                )
            out += _encode_dict_string_page(
                codes[off : off + ln], pv, dcol.offsets, dcol.values, options
            )
            yield bytes(out), ln, None
        return

    vals_dev = col.values
    np_vals = (
        col.host_exact
        if getattr(col, "host_exact", None) is not None
        else np.asarray(vals_dev)
    )
    if field.type is not None and pa.types.is_decimal(field.type):
        # device layout is unscaled int64; file layout is the i128/i256
        # byte matrix (reference decimal family)
        from ..codecs.decimal import compress_decimal

        W = field.type.bit_width // 8
        v = np_vals.astype(np.int64)
        limbs = np.empty((len(v), W // 8), dtype="<i8")
        limbs[:, 0] = v
        if W > 8:
            limbs[:, 1:] = (v >> 63)[:, None]
        mat = limbs.view(np.uint8).reshape(len(v), W)
        for off in range(0, n, page_size):
            ln = min(page_size, n - off)
            pv = None if np_validity is None else np_validity[off : off + ln]
            out = bytearray()
            if field.nullable:
                out += _validity_prelude(
                    None if pv is None or pv.all() else pv, ln
                )
            out += compress_decimal(mat[off : off + ln], pv, options, W)
            # zones on the UNSCALED int64 value — the scan's value domain
            # (predicates on decimals compare unscaled ints)
            yield bytes(out), ln, _page_zone(v[off : off + ln], pv, ln)
        return

    if np_vals.dtype == np.bool_:
        if page_size % 8 == 0:
            # device path: pack bits + per-page counts in ONE device call;
            # the host only slices packed bytes (raw pages) or unpacks the
            # rare RLE/OneValue page — never walks row values
            yield from _encode_bool_pages_device(
                col, field, np_validity, n, page_size, options
            )
            return
        # host fallback (non-byte-aligned page grid): boolean bitmap family
        from ..codecs import compress_boolean

        for off in range(0, n, page_size):
            ln = min(page_size, n - off)
            pv = None if np_validity is None else np_validity[off : off + ln]
            out = bytearray()
            if field.nullable:
                out += _validity_prelude(
                    None if pv is None or pv.all() else pv, ln
                )
            out += compress_boolean(np_vals[off : off + ln], pv, options)
            yield bytes(out), ln, _page_zone(
                np_vals[off : off + ln].astype(np.int64), pv, ln
            )
        return

    # numeric: ONE batched device stats call for every page of the column
    d = paged_stats_device(vals_dev, col.validity, page_size)
    d = {k: np.asarray(v) for k, v in d.items()}
    for i, off in enumerate(range(0, n, page_size)):
        ln = min(page_size, n - off)
        pv = None if np_validity is None else np_validity[off : off + ln]
        out = bytearray()
        if field.nullable:
            out += _validity_prelude(
                None if pv is None or pv.all() else pv, ln
            )
        page_vals = np_vals[off : off + ln]
        stats = _family_stats_from_device(page_vals, pv, d, i)
        # FREQ exact-mode fallback: the device stats carry a distinct
        # *estimate* only, but when it is tiny (a top-heavy page is always
        # low-cardinality) the host bytes are already materialized — one
        # cheap np.unique gives the exact mode, re-enabling FREQ
        allow_freq = False
        if stats.set_count > 0 and stats.unique_count <= 16:
            pvals = page_vals if pv is None else page_vals[pv]
            if len(pvals):
                uq, cnts = np.unique(pvals, return_counts=True)
                top = int(np.argmax(cnts))
                stats.top_value = uq[top]
                stats.max_count = int(cnts[top])
                stats.unique_count = len(uq)
                allow_freq = True
        out += _encode_numeric_page(page_vals, pv, stats, options, allow_freq)
        # zone straight from the device stats reduction (no extra pass);
        # zones of f64 pages come from the exact host bytes (the host_exact
        # copy, ROADMAP D5): a rounded bound could mis-prune
        from ..exec.pruning import PageZone, _py

        if page_vals.dtype == np.dtype(np.float64):
            zone = _page_zone(page_vals, pv, ln)
        elif int(d["set_count"][i]) == 0:
            zone = PageZone(None, None, int(d["null_count"][i]), ln)
        else:
            zone = PageZone(
                _py(page_vals.dtype.type(d["min"][i])),
                _py(page_vals.dtype.type(d["max"][i])),
                int(d["null_count"][i]),
                ln,
            )
        yield bytes(out), ln, zone
