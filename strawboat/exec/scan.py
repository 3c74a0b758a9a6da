"""Device scan: host page planning + on-device decode.

Idiom shift from the reference (SURVEY §7): trait-object per-page dispatch
(src/read/deserialize.rs) becomes *planning* — pages are parsed on the host
(headers only), grouped by codec, re-layouted into dense tensors, and decoded
with one vectorized kernel launch per codec group.  Page skipping
(``Iterator::nth``/``ColumnMeta::slice``) becomes a gather of surviving page
indices from zone maps.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Optional, Sequence

import jax
import jax.numpy as jnp
import numpy as np
import pyarrow as pa

from .. import native
from ..codecs import read_header
from ..codecs import common as common_codec
from ..codecs.double import patas_decode
from ..columns import _np_storage_dtype
from ..constants import Compression
from ..errors import NotYetImplementedError
from ..meta import ColumnMeta
from ..read.levels import read_validity
from ..read.reader import infer_schema, read_meta
from ..schema import is_primitive, n_leaf_columns
from ..util import roaring
from ..kernels.decode import (
    bitunpack_device,
    delta_bitunpack_device,
    dict_gather_device,
    freq_scatter_device,
    one_value_device,
    rle_expand_device,
    unpack_validity_device,
)


@dataclass
class DeviceColumn:
    name: str
    dtype: pa.DataType
    values: jax.Array
    validity: Optional[jax.Array] = None  # bool, True = valid
    # string/binary columns ride as dictionary codes on device; the
    # dictionary itself stays host-side (pa.Array) for literal translation
    dictionary: Optional[pa.Array] = None
    # float64 only: the exact decoded bytes stay host-side for
    # materialization/re-encode, device f64 serves compute.  The first
    # accelerator stored f64 as a float32 pair; the H100's f64 is native, so
    # this copy is a removal candidate (ROADMAP D5)
    host_exact: Optional[np.ndarray] = None

    def __len__(self) -> int:
        return int(self.values.shape[0])


@dataclass
class DeviceTable:
    columns: Dict[str, DeviceColumn]
    num_rows: int

    def __getitem__(self, name: str) -> DeviceColumn:
        return self.columns[name]

    def to_arrow(self, mask=None) -> "pa.Table":
        """Materialize (optionally mask-compacted) columns to a host table."""
        from ..errors import NotYetImplementedError

        sel = None if mask is None else np.flatnonzero(np.asarray(mask))
        arrays = []
        names = []
        for name, c in self.columns.items():
            if getattr(c, "offsets", None) is not None:
                if sel is not None:
                    raise NotYetImplementedError(
                        f"mask-compacted export of list column {name!r}"
                    )
                arrays.append(_list_column_to_arrow(c))
                names.append(name)
                continue
            vals = (
                c.host_exact if c.host_exact is not None else np.asarray(c.values)
            )
            validity = None if c.validity is None else np.asarray(c.validity)
            if sel is not None:
                vals = vals[sel]
                validity = None if validity is None else validity[sel]
            if c.dictionary is not None:
                arr = c.dictionary.take(
                    pa.array(
                        vals,
                        mask=None if validity is None else ~validity,
                    )
                )
                if c.dtype is not None and arr.type != c.dtype:
                    arr = arr.cast(c.dtype)
            elif c.dtype is not None and pa.types.is_decimal(c.dtype):
                arr = _decimal_to_arrow(c, vals, validity)
            else:
                arr = pa.array(
                    vals, mask=None if validity is None else ~validity
                )
                if c.dtype is not None and not pa.types.is_boolean(c.dtype) and arr.type != c.dtype:
                    try:
                        arr = arr.cast(c.dtype)
                    except (pa.ArrowInvalid, pa.ArrowNotImplementedError):
                        pass
            arrays.append(arr)
            names.append(name)
        return pa.table(dict(zip(names, arrays)))


def _list_column_to_arrow(c) -> "pa.Array":
    """Rebuild a pa.ListArray from a flattened DeviceListColumn.

    Multi-level layouts rebuild the full chain from ``offsets_stack``
    (inner→outer) with per-level validity; dictionary-coded leaves decode
    through the host dictionary."""
    child_vals = (
        c.host_exact if c.host_exact is not None else np.asarray(c.values)
    )
    child_mask = (
        None if c.child_validity is None else ~np.asarray(c.child_validity)
    )
    if c.dictionary is not None:
        child = c.dictionary.take(pa.array(child_vals, mask=child_mask))
    else:
        child = pa.array(child_vals, mask=child_mask)
    stack = (
        c.offsets_stack
        if c.offsets_stack is not None
        else (np.asarray(c.offsets),)
    )
    validities = (
        c.list_validities
        if c.list_validities is not None
        else ((np.asarray(c.validity) if c.validity is not None else None),)
    )
    arr = child
    for offs, valid in reversed(list(zip(stack, validities))):
        offs = np.ascontiguousarray(np.asarray(offs).astype(np.int32))
        buffers = [None, pa.py_buffer(offs.tobytes())]
        if valid is not None:
            bitmap = np.packbits(np.asarray(valid), bitorder="little")
            buffers[0] = pa.py_buffer(bitmap.tobytes())
        arr = pa.Array.from_buffers(
            pa.list_(arr.type), len(offs) - 1, buffers, children=[arr]
        )
    if c.dtype is not None and arr.type != c.dtype:
        try:
            arr = arr.cast(c.dtype)
        except (pa.ArrowInvalid, pa.ArrowNotImplementedError):
            pass
    return arr


@dataclass
class PageStats:
    """Zone-map entry derived while planning (min/max for pruning)."""

    min: Optional[float] = None
    max: Optional[float] = None


# ---------------------------------------------------------------------------
# host-side page decode planning


def _decode_structured_host(
    buf: np.ndarray, pos: int, length: int, dtype: np.dtype
) -> np.ndarray:
    """Vectorized numpy decode of one non-bitpacked structured page."""
    from ..codecs.double import decompress_double
    from ..codecs.integer import decompress_integer

    if dtype.kind == "f":
        vals, _ = decompress_double(buf, pos, length, dtype)
    else:
        vals, _ = decompress_integer(buf, pos, length, dtype)
    return np.asarray(vals)


def _pad_pow2(arr: np.ndarray, fill) -> np.ndarray:
    """Pad a 1-D array to the next power of two (bounds jit compile variants:
    per-page run/exception counts otherwise force a fresh XLA compile each)."""
    n = len(arr)
    if n == 0:
        return arr
    target = 1 << (n - 1).bit_length()
    if target == n:
        return arr
    out = np.full(target, fill, dtype=arr.dtype)
    out[:n] = arr
    return out


def _decode_structured_to_device(
    buf: np.ndarray, pos: int, length: int, dtype: np.dtype
):
    """Decode one integer/double page body on device where profitable.

    Returns (jax array of length, consumed_end).  Host fallback for the
    general codecs (LZ4/etc → native lib) and Patas.
    """
    codec, csize, _usize, body = read_header(buf, pos)
    end = body + csize
    if codec.raw_mode:
        raw = common_codec.decompress(
            codec, bytes(buf[body:end]), length * dtype.itemsize
        )
        host = np.frombuffer(raw, dtype=dtype)
        return jnp.asarray(host), end

    if codec == Compression.ONE_VALUE:
        val = np.frombuffer(buf, dtype, 1, body)[0]
        return one_value_device(jnp.asarray(val), length), end

    if codec == Compression.RLE:
        itemsize = dtype.itemsize
        rec = np.dtype(
            {"names": ["len", "val"], "formats": ["<u4", dtype],
             "offsets": [0, 4], "itemsize": 4 + itemsize}
        )
        avail = (len(buf) - body) // rec.itemsize
        recs = np.frombuffer(buf, dtype=rec, count=avail, offset=body)
        cum = np.cumsum(recs["len"].astype(np.int64))
        k = int(np.searchsorted(cum, length, side="left")) + 1
        counts = _pad_pow2(recs["len"][:k].astype(np.int32), 0)
        values = _pad_pow2(recs["val"][:k].copy(), recs["val"][0])
        return (
            rle_expand_device(jnp.asarray(counts), jnp.asarray(values), length),
            end,
        )

    if codec == Compression.DICT:
        indices, ipos = _decode_structured_to_device(
            buf, body, length, np.dtype(np.uint32)
        )
        count = int(np.frombuffer(buf, "<u4", 1, ipos)[0])
        data = _pad_pow2(np.frombuffer(buf, dtype, count, ipos + 4).copy(), 0)
        return dict_gather_device(indices, jnp.asarray(data)), end

    if codec == Compression.FREQ:
        itemsize = dtype.itemsize
        top = np.frombuffer(buf, dtype, 1, body)[0]
        p = body + itemsize
        bm_size = int(np.frombuffer(buf, "<u4", 1, p)[0])
        p += 4
        positions = roaring.deserialize(bytes(buf[p : p + bm_size]))
        p += bm_size
        exceptions, _ = _decode_structured_to_device(
            buf, p, len(positions), dtype
        )
        # pad positions out-of-range (dropped by the scatter) to bound compiles
        pos_pad = _pad_pow2(positions.astype(np.int32), length)
        if len(pos_pad) != len(positions):
            exceptions = jnp.pad(exceptions, (0, len(pos_pad) - len(positions)))
        return (
            freq_scatter_device(
                jnp.asarray(top),
                jnp.asarray(pos_pad),
                exceptions,
                length,
            ),
            end,
        )

    if codec in (Compression.BITPACKING, Compression.DELTA_BITPACKING):
        n_blocks = (length + 127) // 128
        # parse block headers (native walk); fast path: uniform num_bits
        nbs_arr, _bp_end = native.bp_walk(buf, body, n_blocks)
        nbs = nbs_arr.tolist()
        if len(set(nbs)) == 1:
            b = nbs[0]
            stride = 1 + b * 16
            body_arr = np.frombuffer(buf, np.uint8, n_blocks * stride, body)
            words = (
                body_arr.reshape(n_blocks, stride)[:, 1:]
                .copy()
                .view(np.uint32)
            )
            if codec == Compression.BITPACKING:
                out = bitunpack_device(jnp.asarray(words), b).reshape(-1)
                out = out[:length]
            else:
                out = delta_bitunpack_device(words, b)[:length]
        else:
            # mixed widths: pad each block's words to the max width
            bmax = max(nbs)
            words = np.zeros((n_blocks, bmax * 4), dtype=np.uint32)
            p = body
            for i, nb in enumerate(nbs):
                words[i, : nb * 4] = np.frombuffer(
                    buf, np.uint8, nb * 16, p + 1
                ).view(np.uint32)
                p += 1 + nb * 16
            # widths differ per block: decode per distinct width and merge
            out = jnp.zeros(n_blocks * 128, dtype=jnp.uint32).reshape(
                n_blocks, 128
            )
            nbs_arr = np.asarray(nbs)
            for b in sorted(set(nbs)):
                sel = np.flatnonzero(nbs_arr == b)
                dec = bitunpack_device(
                    jnp.asarray(words[sel, : max(b, 1) * 4]), b
                )
                out = out.at[jnp.asarray(sel)].set(dec)
            out = out.reshape(-1)[:length]
            if codec == Compression.DELTA_BITPACKING:
                out = jnp.cumsum(out.astype(jnp.uint32), dtype=jnp.uint32)[
                    :length
                ]
        if dtype.itemsize == 4:
            out = jax.lax.bitcast_convert_type(out, jnp.dtype(dtype))
        return out, end

    if codec == Compression.PATAS:
        host, _ = patas_decode(buf, body, length, dtype)
        return jnp.asarray(host), end

    raise NotYetImplementedError(f"device decode for {codec}")


def _parse_uniform_bp_page(buf, body: int, length: int):
    """If every block of a bitpacked page shares one width → (words, n_blocks, b)."""
    n_blocks = (length + 127) // 128
    nbs, _end = native.bp_walk(buf, body, n_blocks)
    b = int(nbs[0])
    if b == 0 or not (nbs == nbs[0]).all():
        return None
    stride = 1 + b * 16
    body_arr = np.frombuffer(buf, np.uint8, n_blocks * stride, body)
    words = body_arr.reshape(n_blocks, stride)[:, 1:].copy().view(np.uint32)
    return words, n_blocks, b


def _decode_bp_group_arrays(bp_jobs):
    """Decode many bitpacked pages with one kernel launch per (codec, b).

    Returns ({group_key: flat u32 device array},
             {page_idx: (group_key, offset, n_vals)}).
    """
    from collections import defaultdict

    groups = defaultdict(list)
    for job in bp_jobs:
        idx, codec, words, n_blocks, b, length = job
        groups[(codec, b)].append(job)
    group_arrays = {}
    page_ref = {}
    for gkey, jobs in groups.items():
        codec, b = gkey
        all_words = np.concatenate([j[2] for j in jobs], axis=0)
        dec = bitunpack_device(jnp.asarray(all_words), b).reshape(-1)
        if codec == Compression.DELTA_BITPACKING:
            flat = dec
            starts = np.cumsum([0] + [j[3] * 128 for j in jobs])
            total = int(starts[-1])
            # per-page prefix-sum restart (delta carries within a page only)
            g = jnp.cumsum(flat.astype(jnp.uint32), dtype=jnp.uint32)
            base = jnp.concatenate(
                [jnp.zeros(1, jnp.uint32), g[jnp.asarray(starts[1:-1]) - 1]]
            )
            page_base = jnp.repeat(
                base,
                jnp.asarray([j[3] * 128 for j in jobs]),
                total_repeat_length=total,
            )
            dec = g - page_base
        else:
            dec = dec.reshape(-1)
        group_arrays[gkey] = dec
        off = 0
        for idx, _c, _w, n_blocks, _b, length in jobs:
            page_ref[idx] = (gkey, off, n_blocks * 128)
            off += n_blocks * 128
    return group_arrays, page_ref


def _decode_dict_group_arrays(dict_jobs, np_dtype, group_arrays, page_ref):
    """Decode many dict pages with one unpack + one gather per index width.

    Uploads only packed index bits + concatenated dictionaries; per-page
    dictionaries are addressed by adding each page's base offset to its codes
    (one ``jnp.repeat`` of the static page-slot sizes).  Extends
    ``group_arrays``/``page_ref`` in place with ``("dict", b)`` groups.
    """
    from collections import defaultdict

    groups = defaultdict(list)
    for job in dict_jobs:
        groups[job[3]].append(job)  # key: index bit width
    for b, jobs in groups.items():
        all_words = np.concatenate([j[1] for j in jobs], axis=0)
        total = all_words.shape[0] * 128
        codes = bitunpack_device(jnp.asarray(all_words), b).reshape(-1)
        codes = codes.astype(jnp.int32)
        dicts = [j[5] for j in jobs]
        bases = np.zeros(len(jobs), dtype=np.int32)
        bases[1:] = np.cumsum([len(d) for d in dicts[:-1]])
        slot_sizes = np.asarray([j[2] * 128 for j in jobs])
        base_rep = jnp.repeat(
            jnp.asarray(bases), jnp.asarray(slot_sizes), total_repeat_length=total
        )
        all_dict = jnp.asarray(np.concatenate(dicts))
        dec = dict_gather_device(codes + base_rep, all_dict)
        gkey = ("dict", b)
        group_arrays[gkey] = dec
        off = 0
        for idx, _w, n_blocks, _b, length, _d in jobs:
            page_ref[idx] = (gkey, off, n_blocks * 128)
            off += n_blocks * 128


def _parse_varwidth_bp_page(buf, body: int, length: int):
    """Any bitpacked page → zero-padded words + per-block widths.

    Returns (words (n, bmax*4) u32, n_blocks, widths (n,) i32, bmax) or None
    without the native header walk.  One vectorized byte gather per distinct
    width — no per-block python loop.
    """
    if not native.available():
        return None
    n_blocks = (length + 127) // 128
    nbs, _end = native.bp_walk(buf, body, n_blocks)
    widths = nbs.astype(np.int32)
    bmax = int(widths.max()) if n_blocks else 0
    if bmax == 0 or bmax > 32:
        return None
    sizes = 1 + widths.astype(np.int64) * 16
    offs = np.zeros(n_blocks + 1, dtype=np.int64)
    np.cumsum(sizes, out=offs[1:])
    offs += body
    words = np.zeros((n_blocks, bmax * 4), dtype=np.uint32)
    u8 = words.view(np.uint8)
    for w in np.unique(widths):
        w = int(w)
        if w == 0:
            continue
        sel = np.flatnonzero(widths == w)
        idx = offs[sel][:, None] + 1 + np.arange(w * 16)
        u8[sel, : w * 16] = buf[idx]
    return words, n_blocks, widths, bmax


def _decode_varwidth_groups(bpv_jobs, group_arrays, page_ref):
    """Decode mixed-width bitpacked pages with ONE varwidth kernel launch per
    (kind, delta?) group — widths ride as data (bitunpack_varwidth_device),
    so a page whose blocks span several widths costs no extra dispatches.

    bpv_jobs: (idx, kind, words, n_blocks, widths, bmax, length, is_delta,
    dvals|None); kind in {"bpv", "dictv"}.  Extends group_arrays/page_ref.
    """
    from collections import defaultdict

    from ..kernels.decode import bitunpack_varwidth_device

    groups = defaultdict(list)
    for job in bpv_jobs:
        groups[(job[1], job[7])].append(job)
    for (kind, is_delta), jobs in groups.items():
        bmax = max(j[5] for j in jobs)
        padded = []
        for j in jobs:
            w = j[2]
            if w.shape[1] < bmax * 4:
                w = np.pad(w, ((0, 0), (0, bmax * 4 - w.shape[1])))
            padded.append(w)
        all_words = np.concatenate(padded, axis=0)
        all_widths = np.concatenate([j[4] for j in jobs])
        total = all_words.shape[0] * 128
        dec = bitunpack_varwidth_device(
            jnp.asarray(all_words), jnp.asarray(all_widths), bmax
        ).reshape(-1)
        slot_sizes = np.asarray([j[3] * 128 for j in jobs])
        if is_delta:
            # per-page prefix-sum restart (delta carries within a page only)
            starts = np.zeros(len(jobs) + 1, dtype=np.int64)
            np.cumsum(slot_sizes, out=starts[1:])
            g = jnp.cumsum(dec.astype(jnp.uint32), dtype=jnp.uint32)
            base = jnp.concatenate(
                [jnp.zeros(1, jnp.uint32), g[jnp.asarray(starts[1:-1]) - 1]]
            )
            dec = g - jnp.repeat(
                base, jnp.asarray(slot_sizes), total_repeat_length=total
            )
        if kind == "dictv":
            dicts = [j[8] for j in jobs]
            bases = np.zeros(len(jobs), dtype=np.int32)
            bases[1:] = np.cumsum([len(d) for d in dicts[:-1]])
            base_rep = jnp.repeat(
                jnp.asarray(bases),
                jnp.asarray(slot_sizes),
                total_repeat_length=total,
            )
            all_dict = jnp.asarray(np.concatenate(dicts))
            dec = dict_gather_device(dec.astype(jnp.int32) + base_rep, all_dict)
        gkey = (kind, is_delta)
        group_arrays[gkey] = dec
        off = 0
        for j in jobs:
            page_ref[j[0]] = (gkey, off, j[3] * 128)
            off += j[3] * 128


_UPLOAD_CHUNK = 32 << 20  # bytes per staged host→device transfer

# jitted concat: an eager concatenate of freshly uploaded chunks costs a
# dispatch per call; the jitted form re-traces per (count, shapes) and then
# replays from the executable cache
_concat_device = jax.jit(lambda *xs: jnp.concatenate(xs))


def _assemble_validity(vparts):
    """vparts: list of (length, validity|None).  None ≡ all-valid; a column
    where no page carries nulls uploads NO mask at all."""
    if not vparts or all(v is None for _l, v in vparts):
        return None
    return jnp.asarray(
        np.concatenate(
            [np.ones(l, dtype=bool) if v is None else v for l, v in vparts]
        )
    )


def _decode_raw_column_streamed(plans, np_dtype, keep_exact=False):
    """Streamed decode for a column whose pages are ALL common-codec.

    Pages decompress on native threads directly into one pooled host arena
    (no per-page allocation, no concatenate), in ~32 MB chunks; each chunk's
    host→device transfer is dispatched asynchronously, so the next chunk's
    decompression overlaps the previous chunk's upload — the double-buffered
    feed of SURVEY §2.8.  Returns None when the shape doesn't qualify
    (mixed structured codecs, no native runtime).
    """
    if np_dtype is None or not plans or not native.available():
        return None
    from . import arena

    jobs = []  # (codec_int, in_slice, out_len)
    for length, _v, buf, p in plans:
        codec, csize, _us, body = read_header(buf, p)
        if not codec.raw_mode:
            return None
        jobs.append((int(codec), buf[body : body + csize], length * np_dtype.itemsize))
    out_lens = np.asarray([j[2] for j in jobs], dtype=np.int64)
    offsets = np.zeros(len(jobs) + 1, dtype=np.int64)
    np.cumsum(out_lens, out=offsets[1:])
    total = int(offsets[-1])
    if total == 0:
        return jnp.zeros(0, dtype=jnp.dtype(np_dtype)), None
    on_cpu = jax.default_backend() == "cpu"
    buf = arena.acquire(total) if not on_cpu else np.empty(total, dtype=np.uint8)

    # chunk boundaries on page edges, ~_UPLOAD_CHUNK decoded bytes apiece
    parts = []
    start = 0
    n = len(jobs)
    while start < n:
        end = start + 1
        while end < n and offsets[end + 1] - offsets[start] <= _UPLOAD_CHUNK:
            end += 1
        chunk = jobs[start:end]
        base = int(offsets[start])
        # one native call per codec run inside the chunk (usually exactly one)
        i = 0
        while i < len(chunk):
            j = i + 1
            while j < len(chunk) and chunk[j][0] == chunk[i][0]:
                j += 1
            native.decompress_batch_into(
                chunk[i][0],
                [c[1] for c in chunk[i:j]],
                buf,
                offsets[start + i : start + j],
                out_lens[start + i : start + j],
            )
            i = j
        view = buf[base : int(offsets[end])].view(np_dtype)
        parts.append(jnp.asarray(view))  # async transfer; overlaps next chunk
        start = end
    values = _concat_device(*parts) if len(parts) > 1 else parts[0]
    host_exact = buf.view(np_dtype).copy() if keep_exact else None
    if not on_cpu:
        arena.release(buf, parts)
    return values, host_exact


def decode_column_pages_device(
    file_bytes: np.ndarray,
    meta: ColumnMeta,
    field: pa.Field,
    keep: Optional[np.ndarray] = None,
) -> DeviceColumn:
    """Decode the (surviving) pages of a simple column to device buffers.

    ``keep`` is a per-page boolean mask from zone-map pruning; dropped pages
    are seek-skipped exactly like the reference's ``Iterator::nth``
    (reader.rs:91-116).  Contiguous raw-codec pages batch-decompress on
    native threads when the runtime is available.
    """
    dtype = field.type
    np_dtype = _np_storage_dtype(dtype) if not pa.types.is_boolean(dtype) else None
    nullable = bool(field.nullable)

    # pass 1: locate page bodies
    plans = []  # (length, validity_arr|None, codec, body_slice|None, page_buf, p)
    pos = meta.offset
    for i, page in enumerate(meta.pages):
        page_end = pos + page.length
        if keep is not None and not keep[i]:
            pos = page_end
            continue
        buf = file_bytes[pos:page_end]
        p = 0
        length = page.num_values
        validity = None
        if nullable:
            validity, p = read_validity(buf, p, length)
        plans.append((length, validity, buf, p))
        pos = page_end

    if pa.types.is_boolean(dtype):
        return _decode_boolean_column_batched(plans, field, nullable)

    # keep the exact f64 bytes host-side for materialization/re-encode
    # (a copy the H100's native f64 may not need: ROADMAP D5)
    exact_f64 = np_dtype is not None and np_dtype == np.dtype(np.float64)

    # fast path: all-common-codec column → streamed arena decode + chunked
    # overlapped upload (no per-page allocation, no concatenate pass)
    if not pa.types.is_boolean(dtype):
        res = _decode_raw_column_streamed(plans, np_dtype, keep_exact=exact_f64)
        if res is not None:
            values, host_exact = res
            validity = None
            # validity=None ≡ all-valid: only materialize (and upload) a mask
            # when some page actually carries nulls
            if nullable and any(v is not None for (_l, v, _b, _p) in plans):
                vparts = [
                    np.ones(l, dtype=bool) if v is None else v
                    for (l, v, _b, _p) in plans
                ]
                validity = jnp.asarray(np.concatenate(vparts))
            return DeviceColumn(
                field.name, dtype, values, validity, host_exact=host_exact
            )

    # batched native decompression for raw-codec primitive pages
    raw_jobs = []
    bp_jobs = []  # (idx, codec, words, n_blocks, num_bits, length)
    dict_jobs = []  # (idx, words, n_blocks, idx_bits, length, dict_vals)
    bpv_jobs = []  # mixed-width/delta pages: see _decode_varwidth_groups
    for idx, (length, _v, buf, p) in enumerate(plans):
        if pa.types.is_boolean(dtype):
            continue
        codec, csize, _us, body = read_header(buf, p)
        if codec.raw_mode and codec != Compression.NONE:
            raw_jobs.append((idx, codec, buf[body : body + csize], length))
        elif codec in (Compression.BITPACKING, Compression.DELTA_BITPACKING):
            parsed = _parse_uniform_bp_page(buf, body, length)
            if parsed is not None:
                bp_jobs.append((idx, codec, *parsed, length))
            else:
                pv = _parse_varwidth_bp_page(buf, body, length)
                if pv is not None:
                    words, n_blocks, widths, bmax = pv
                    bpv_jobs.append(
                        (idx, "bpv", words, n_blocks, widths, bmax, length,
                         codec == Compression.DELTA_BITPACKING, None)
                    )
        elif codec == Compression.DICT and np_dtype is not None and not (
            np_dtype == np.dtype(np.float64)
        ):
            # dict page with bitpacked (or delta-bitpacked) index subpage:
            # upload only the packed index bits + the (small) dictionary,
            # decode + gather on device — not host-decode + 8B/row upload
            icodec, icsize, _ius, ibody = read_header(buf, body)
            if icodec in (
                Compression.BITPACKING,
                Compression.DELTA_BITPACKING,
            ):
                vpos = ibody + icsize
                count = int(np.frombuffer(buf, "<u4", 1, vpos)[0])
                dvals = np.frombuffer(buf, np_dtype, count, vpos + 4).copy()
                if count == 0:  # all-null page: codes are 0
                    dvals = np.zeros(1, dtype=np_dtype)
                parsed = (
                    _parse_uniform_bp_page(buf, ibody, length)
                    if icodec == Compression.BITPACKING
                    else None
                )
                if parsed is not None:
                    words, n_blocks, b = parsed
                    dict_jobs.append((idx, words, n_blocks, b, length, dvals))
                else:
                    pv = _parse_varwidth_bp_page(buf, ibody, length)
                    if pv is not None:
                        words, n_blocks, widths, bmax = pv
                        bpv_jobs.append(
                            (idx, "dictv", words, n_blocks, widths, bmax,
                             length, icodec == Compression.DELTA_BITPACKING,
                             dvals)
                        )
    raw_results = {}
    if len(raw_jobs) > 1:
        from .. import native

        if native.available() and len({j[1] for j in raw_jobs}) == 1:
            outs = native.decompress_batch(
                int(raw_jobs[0][1]),
                [j[2] for j in raw_jobs],
                [j[3] * np_dtype.itemsize for j in raw_jobs],
            )
            for (idx, _c, _b, _l), out in zip(raw_jobs, outs):
                raw_results[idx] = out.view(np_dtype)
    # one fused kernel launch per (codec, num_bits) group of bitpacked pages
    bp_group_arrays = {}
    bp_page_ref = {}
    if len(bp_jobs) > 1:
        bp_group_arrays, bp_page_ref = _decode_bp_group_arrays(bp_jobs)
    if dict_jobs:
        _decode_dict_group_arrays(
            dict_jobs, np_dtype, bp_group_arrays, bp_page_ref
        )
    if bpv_jobs:
        _decode_varwidth_groups(bpv_jobs, bp_group_arrays, bp_page_ref)

    # assembly: host parts concatenate in numpy (1 upload), device parts from
    # fused group kernels; per-page eager jax ops are the enemy here
    parts = []  # (kind, payload): kind in {host, device}
    host_acc = []
    host_keep = []  # exact f64 bytes (ROADMAP D5)

    def flush_host():
        if host_acc:
            joined = np.concatenate(host_acc)
            if exact_f64:
                host_keep.append(joined)
            parts.append(("device", jnp.asarray(joined)))
            host_acc.clear()

    vparts = []
    for idx, (length, validity, buf, p) in enumerate(plans):
        if nullable:
            vparts.append((length, validity))
        if idx in bp_page_ref:
            gkey, off, n_vals = bp_page_ref[idx]
            flush_host()
            parts.append(("slice", (gkey, off, n_vals, length)))
        elif idx in raw_results:
            host_acc.append(raw_results[idx])
        elif pa.types.is_boolean(dtype):
            flush_host()
            parts.append(("device", _decode_boolean_page_device(buf, p, length)))
        else:
            # structured non-bitpacked pages (rle/dict/freq/one_value/patas):
            # vectorized numpy host decode → single device upload per column
            # (per-page device dispatch overhead dwarfs the decode itself; the
            # bitpacked fast path above stays fully on-device)
            host_acc.append(_decode_structured_host(buf, p, length, np_dtype))
    flush_host()

    if not parts:
        values = jnp.zeros(0, dtype=jnp.dtype(np_dtype) if np_dtype else jnp.bool_)
        return DeviceColumn(field.name, dtype, values, None)

    # merge consecutive full-page slices of one group into single slices
    merged = []
    for kind, payload in parts:
        if (
            kind == "slice"
            and merged
            and merged[-1][0] == "slice"
            and merged[-1][1][0] == payload[0]
            and merged[-1][1][1] + merged[-1][1][2] == payload[1]
            and merged[-1][1][2] == merged[-1][1][3]  # previous page full
        ):
            g, off, n_vals, length = merged[-1][1]
            merged[-1] = ("slice", (g, off, n_vals + payload[2], length + payload[3]))
        else:
            merged.append((kind, payload))
    device_parts = []
    for kind, payload in merged:
        if kind == "device":
            device_parts.append(payload)
        else:
            gkey, off, n_vals, length = payload
            arr = jax.lax.dynamic_slice(bp_group_arrays[gkey], (off,), (n_vals,))[
                :length
            ]
            if np_dtype is not None and np_dtype.itemsize == 4:
                arr = jax.lax.bitcast_convert_type(arr, jnp.dtype(np_dtype))
            device_parts.append(arr)
    values = (
        _concat_device(*device_parts) if len(device_parts) > 1 else device_parts[0]
    )
    validity = _assemble_validity(vparts) if nullable else None
    host_exact = None
    if exact_f64 and host_keep:
        # every f64 page decodes host-side (raw/structured/patas), so the
        # kept parts cover the whole column in order
        host_exact = (
            np.concatenate(host_keep) if len(host_keep) > 1 else host_keep[0]
        )
        if len(host_exact) != int(values.shape[0]):
            host_exact = None  # mixed device parts: no exact cover
    return DeviceColumn(
        field.name, dtype, values, validity, host_exact=host_exact
    )


def _decode_boolean_column_batched(plans, field, nullable) -> DeviceColumn:
    """All boolean pages → ONE packed-bit upload + one device expand.

    Raw pages contribute their bitmap bytes directly; structured pages
    (RLE/OneValue) host-decode then re-pack.  Pages with a non-byte-multiple
    row count (only ever the last on the fixed page grid) keep bit
    alignment by going through the bool repack.
    """
    from ..codecs import decompress_boolean

    parts = []  # np.uint8 packed (byte-aligned) | ("bits", bool array)
    vparts = []
    aligned = True
    bools = []
    for length, validity, buf, p in plans:
        if nullable:
            vparts.append((length, validity))
        codec, csize, _us, body = read_header(buf, p)
        if codec.raw_mode:
            raw = common_codec.decompress(
                codec, bytes(buf[body : body + csize]), (length + 7) // 8
            )
            bits = np.unpackbits(
                np.frombuffer(raw, np.uint8), count=length, bitorder="little"
            ).astype(bool)
        else:
            bits, _ = decompress_boolean(buf, p, length)
            bits = np.asarray(bits, dtype=bool)
        bools.append(bits)
    if not bools:
        return DeviceColumn(field.name, field.type, jnp.zeros(0, jnp.bool_), None)
    all_bits = np.concatenate(bools)
    total = len(all_bits)
    packed = np.packbits(all_bits, bitorder="little")
    values = unpack_validity_device(jnp.asarray(packed), total)
    validity = _assemble_validity(vparts) if nullable else None
    return DeviceColumn(field.name, field.type, values, validity)


def _decode_boolean_page_device(buf: np.ndarray, pos: int, length: int) -> jax.Array:
    """Boolean page: raw bitmap bytes expand on device; RLE/OneValue on host."""
    codec, csize, _us, body = read_header(buf, pos)
    if codec.raw_mode:
        raw = common_codec.decompress(
            codec, bytes(buf[body : body + csize]), (length + 7) // 8
        )
        return unpack_validity_device(
            jnp.asarray(np.frombuffer(raw, np.uint8)), length
        )
    from ..codecs import decompress_boolean

    host_vals, _ = decompress_boolean(buf, pos, length)
    return jnp.asarray(host_vals)


def _decode_decimal_column_device(
    file_bytes: np.ndarray,
    meta: ColumnMeta,
    field: pa.Field,
    keep: Optional[np.ndarray] = None,
) -> DeviceColumn:
    """decimal128/256 column → unscaled int64 on device (precision ≤ 18).

    10^18 < 2^63, so every decimal the reference's i128/i256 byte-matrix
    family stores with precision ≤ 18 fits an int64 exactly — the engine's
    money layout (int64 sums are exact on device, unlike f64 sums).  Wider decimals
    raise rather than truncate.
    """
    from ..codecs.decimal import decompress_decimal

    W = field.type.bit_width // 8
    nullable = bool(field.nullable)
    pos = meta.offset
    mats = []
    vparts = []
    for i, page in enumerate(meta.pages):
        page_end = pos + page.length
        if keep is not None and not keep[i]:
            pos = page_end
            continue
        buf = file_bytes[pos:page_end]
        p = 0
        length = page.num_values
        validity = None
        if nullable:
            validity, p = read_validity(buf, p, length)
            vparts.append((length, validity))
        mat, _ = decompress_decimal(buf, p, length, W)
        mats.append(np.ascontiguousarray(mat))
        pos = page_end
    if not mats:
        return DeviceColumn(field.name, field.type, jnp.zeros(0, jnp.int64), None)
    all_mat = np.concatenate(mats)
    lo = all_mat[:, :8].copy().view(np.int64).reshape(-1)
    sign_ext = np.where(lo < 0, np.uint8(255), np.uint8(0))
    if field.type.precision > 18 or not (
        all_mat[:, 8:] == sign_ext[:, None]
    ).all():
        raise NotYetImplementedError(
            f"device scan of decimal {field.type} wider than int64"
        )
    validity = _assemble_validity(vparts) if nullable else None
    return DeviceColumn(field.name, field.type, jnp.asarray(lo), validity)


def _decimal_to_arrow(c, vals: np.ndarray, validity) -> "pa.Array":
    """Unscaled int64 → decimal byte-matrix arrow array (sign-extended)."""
    W = c.dtype.bit_width // 8
    v = vals.astype(np.int64)
    limbs = np.empty((len(v), W // 8), dtype="<i8")
    limbs[:, 0] = v
    if W > 8:
        limbs[:, 1:] = (v >> 63)[:, None]
    null_bitmap = None
    if validity is not None:
        null_bitmap = pa.py_buffer(
            np.packbits(validity, bitorder="little").tobytes()
        )
    return pa.Array.from_buffers(
        c.dtype, len(v), [null_bitmap, pa.py_buffer(limbs.tobytes())]
    )


def _dictionary_encode(arr: "pa.Array"):
    """Per-row dictionary encode (arrow C++).  Module-level seam so tests can
    assert the dict-page fast path never re-encodes row data."""
    return arr.dictionary_encode()


def _parse_binary_dict_sets(buf: np.ndarray, pos: int, count: int) -> "pa.Array":
    """Parse a binary dict page's ``[u64 len][bytes]*count`` set list
    (reference binary/dict.rs:90-99) into a pa.binary array."""
    lens = np.empty(count, dtype=np.int64)
    parts = []
    for i in range(count):
        ln = int(np.frombuffer(buf, "<u8", 1, pos)[0])
        pos += 8
        parts.append(buf[pos : pos + ln])
        pos += ln
        lens[i] = ln
    offs = np.zeros(count + 1, dtype=np.int32)
    np.cumsum(lens, out=offs[1:])
    values = np.concatenate(parts) if parts else np.empty(0, np.uint8)
    return pa.Array.from_buffers(
        pa.binary(),
        count,
        [None, pa.py_buffer(offs.tobytes()), pa.py_buffer(values.tobytes())],
    )


def _decode_binary_column_device(
    file_bytes: np.ndarray,
    meta: ColumnMeta,
    field: pa.Field,
    keep: Optional[np.ndarray] = None,
) -> DeviceColumn:
    """Binary/utf8 column → dictionary codes on device + host dictionary.

    Dict-codec pages never re-encode: their packed index bits upload
    directly (device bitunpack when the index subpage is uniform bitpack,
    host u32 decode otherwise) and the per-page dictionaries merge through a
    small host pool (``pc.unique`` + ``index_in`` remap).  Only raw-mode
    pages — where strings arrive as plain offsets+bytes — go through arrow's
    per-row ``dictionary_encode``.  Ref layout: binary/dict.rs:55-141.
    """
    from ..codecs import decompress_binary
    from ..codecs.integer import decompress_integer

    odt = np.int64 if (
        pa.types.is_large_string(field.type) or pa.types.is_large_binary(field.type)
    ) else np.int32
    nullable = bool(field.nullable)
    pos = meta.offset
    vparts = []
    # per page: ("bp", words, n_blocks, b, length, dict_arr)
    #         | ("codes", np_codes, dict_arr)     [dict page, host indices]
    #         | ("raw", pa_array)                 [needs per-row encode]
    plans = []
    for i, page in enumerate(meta.pages):
        page_end = pos + page.length
        if keep is not None and not keep[i]:
            pos = page_end
            continue
        buf = file_bytes[pos:page_end]
        p = 0
        length = page.num_values
        validity = None
        if nullable:
            validity, p = read_validity(buf, p, length)
            vparts.append((length, validity))
        codec, csize, _us, body = read_header(buf, p)
        if codec == Compression.DICT:
            icodec, icsize, _ius, ibody = read_header(buf, body)
            parsed = (
                _parse_uniform_bp_page(buf, ibody, length)
                if icodec == Compression.BITPACKING
                else None
            )
            if parsed is not None:
                words, n_blocks, b = parsed
                vpos = ibody + icsize
            else:
                indices, vpos = decompress_integer(
                    buf, body, length, np.dtype(np.uint32)
                )
            count = int(np.frombuffer(buf, "<u4", 1, vpos)[0])
            dict_arr = _parse_binary_dict_sets(buf, vpos + 4, count)
            if count == 0:  # all-null page: codes are 0 → one empty slice
                dict_arr = pa.array([b""], pa.binary())
            if parsed is not None:
                plans.append(("bp", words, n_blocks, b, length, dict_arr))
            else:
                plans.append(("codes", indices.astype(np.int32), dict_arr))
        else:
            offsets, values, _ = decompress_binary(buf, p, length, np.dtype(odt))
            typ = pa.large_binary() if odt == np.int64 else pa.binary()
            plans.append(
                (
                    "raw",
                    pa.Array.from_buffers(
                        typ,
                        length,
                        [
                            None,
                            pa.py_buffer(np.ascontiguousarray(offsets).tobytes()),
                            pa.py_buffer(np.ascontiguousarray(values).tobytes()),
                        ],
                    ),
                )
            )
        pos = page_end
    if not plans:
        return DeviceColumn(
            field.name, field.type, jnp.zeros(0, jnp.int32), None, None
        )

    # per-row encode for raw pages only (reference-style plain framing)
    raw_arrays = [p[1] for p in plans if p[0] == "raw"]
    raw_dict = None
    raw_codes_flat = None
    if raw_arrays:
        combined = (
            pa.concat_arrays(raw_arrays) if len(raw_arrays) > 1 else raw_arrays[0]
        )
        enc = _dictionary_encode(combined)
        raw_codes_flat = enc.indices.to_numpy(zero_copy_only=False).astype(
            np.int32
        )
        raw_dict = enc.dictionary

    # merge dictionaries: pool = page dicts (+ raw dict), dedupe ONCE on the
    # small pool — never over row data
    pool_parts = [p[-1] for p in plans if p[0] in ("bp", "codes")]
    if raw_dict is not None:
        pool_parts.append(raw_dict.cast(pa.binary()))
    if len(pool_parts) == 1 and raw_dict is None:
        global_dict = pool_parts[0]
        remap = np.arange(len(global_dict), dtype=np.int32)
    else:
        import pyarrow.compute as pc

        pool = pa.concat_arrays([d.cast(pa.binary()) for d in pool_parts])
        global_dict = pc.unique(pool)
        remap = pc.index_in(pool, value_set=global_dict).to_numpy(
            zero_copy_only=False
        ).astype(np.int32)
    # base offset of each pool part
    bases = np.zeros(len(pool_parts) + 1, dtype=np.int64)
    np.cumsum([len(d) for d in pool_parts], out=bases[1:])

    # assemble codes in page order; device bitunpack grouped per width
    bp_jobs = []  # (plan_idx, words, n_blocks, b, length, base)
    part_i = 0
    raw_base = int(bases[-2]) if raw_dict is not None else 0
    page_parts = []  # ("host", np_codes) | ("bpjob", job_index)
    raw_cursor = 0
    for plan in plans:
        kind = plan[0]
        if kind == "bp":
            _k, words, n_blocks, b, length, _d = plan
            bp_jobs.append((len(bp_jobs), words, n_blocks, b, length, int(bases[part_i])))
            page_parts.append(("bpjob", len(bp_jobs) - 1))
            part_i += 1
        elif kind == "codes":
            _k, codes, _d = plan
            page_parts.append(("host", remap[codes + int(bases[part_i])]))
            part_i += 1
        else:
            n = len(plan[1])
            page_parts.append(
                ("host", remap[raw_codes_flat[raw_cursor : raw_cursor + n] + raw_base])
            )
            raw_cursor += n

    device_code_parts = []
    if bp_jobs:
        # group by width: one fused unpack + base-add + remap gather per width
        from collections import defaultdict

        remap_dev = jnp.asarray(remap)
        groups = defaultdict(list)
        for job in bp_jobs:
            groups[job[3]].append(job)
        job_slices = {}
        for b, jobs in groups.items():
            all_words = np.concatenate([j[1] for j in jobs], axis=0)
            total = all_words.shape[0] * 128
            codes = bitunpack_device(jnp.asarray(all_words), b).reshape(-1)
            codes = codes.astype(jnp.int32)
            slot_sizes = np.asarray([j[2] * 128 for j in jobs])
            base_rep = jnp.repeat(
                jnp.asarray([j[5] for j in jobs], dtype=jnp.int32),
                jnp.asarray(slot_sizes),
                total_repeat_length=total,
            )
            gcodes = remap_dev[codes + base_rep]
            off = 0
            for j in jobs:
                job_slices[j[0]] = (gcodes, off, j[2] * 128, j[4])
                off += j[2] * 128
    # concatenate parts in page order, merging host runs into single uploads
    host_acc = []

    def flush_host():
        if host_acc:
            device_code_parts.append(jnp.asarray(np.concatenate(host_acc)))
            host_acc.clear()

    for kind, payload in page_parts:
        if kind == "host":
            host_acc.append(payload)
        else:
            flush_host()
            gcodes, off, n_slot, length = job_slices[payload]
            device_code_parts.append(
                jax.lax.dynamic_slice(gcodes, (off,), (n_slot,))[:length]
            )
    flush_host()
    codes = (
        _concat_device(*device_code_parts)
        if len(device_code_parts) > 1
        else device_code_parts[0]
    )
    validity = _assemble_validity(vparts) if nullable else None
    return DeviceColumn(
        field.name,
        field.type,
        codes,
        validity,
        dictionary=global_dict,
    )


@dataclass
class DeviceListColumn(DeviceColumn):
    """list-typed column on device: flattened leaf values + row offsets.

    ``offsets`` is always the COMPOSED row→leaf-value mapping (usable
    directly by segment ops like ``list_segment_sum`` regardless of depth).
    For multi-level layouts (list<list<...>>) the full per-level offset
    chain is kept in ``offsets_stack`` (outer→inner, each zero-based) with
    matching per-level validities in ``list_validities``, so ``to_arrow``
    can rebuild the exact nested array.  Ref: the reference's NestedState
    (read_basic.rs:65-173) carries the same per-depth offsets/validity.
    """

    offsets: Optional[jax.Array] = None  # (n_rows + 1,) composed row→leaf
    child_validity: Optional[jax.Array] = None  # per flattened leaf value
    offsets_stack: Optional[tuple] = None  # per-level offsets, outer→inner
    list_validities: Optional[tuple] = None  # per-level validity (or None)

    def __len__(self) -> int:
        return int(self.offsets.shape[0]) - 1 if self.offsets is not None else 0


def _flatten_nested_device(name: str, col) -> list:
    """Host nested column → flat device columns.

    struct fields unnest to ``parent.child`` columns; any chain of list
    levels over a numeric/binary/struct leaf becomes DeviceListColumn(s)
    with a per-level offset stack (list<list<numeric>>, list<struct<...>>,
    map, fixed-size list all covered; ref batch_read.rs:66-187).  Binary
    leaves ride as dictionary codes like top-level strings.  Unsupported
    layouts raise instead of silently dropping the column.
    """
    from ..columns import (
        BinaryColumn,
        FixedSizeListColumn,
        ListColumn,
        MapColumn,
        NullColumn,
        PrimitiveColumn,
        StructColumn,
    )

    out = []
    if isinstance(col, NullColumn):
        n = len(col)
        return [
            DeviceColumn(
                name, col.dtype, jnp.zeros(n, jnp.int32), jnp.zeros(n, jnp.bool_)
            )
        ]
    if isinstance(col, StructColumn):
        for child, f in zip(col.children, col.dtype):
            out.extend(_flatten_nested_device(f"{name}.{f.name}", child))
        return out
    if isinstance(col, (ListColumn, MapColumn, FixedSizeListColumn)):
        return _flatten_list_chain(name, col, [], [], col.dtype)
    if isinstance(col, PrimitiveColumn) and col.values.ndim == 1:
        out.append(
            DeviceColumn(
                name,
                col.dtype,
                jnp.asarray(col.values),
                jnp.asarray(col.validity) if col.validity is not None else None,
            )
        )
        return out
    if isinstance(col, BinaryColumn):
        return [_binary_leaf_device(name, col, col.dtype, None, None)]
    raise NotYetImplementedError(
        f"device layout for nested column {name!r} ({type(col).__name__})"
    )


def _flatten_list_chain(name, col, offs_chain, valid_chain, dtype):
    """Walk list levels (list / map / fixed-size list), accumulating the
    zero-based offsets chain; emit DeviceListColumn(s) at the leaf."""
    from ..columns import (
        BinaryColumn,
        FixedSizeListColumn,
        ListColumn,
        MapColumn,
        PrimitiveColumn,
        StructColumn,
    )

    if isinstance(col, FixedSizeListColumn):
        offs = np.arange(len(col) + 1, dtype=np.int64) * col.size
        children = [("", col.child)]
    elif isinstance(col, MapColumn):
        offs = col.offsets.astype(np.int64)
        children = [(".key", col.keys), (".value", col.items)]
    else:  # ListColumn
        offs = col.offsets.astype(np.int64)
        children = [("", col.child)]

    base, end = int(offs[0]), int(offs[-1])
    offs0 = offs - base
    chain = offs_chain + [offs0]
    valids = valid_chain + [col.validity]

    out = []
    for suffix, child in children:
        cname = name + suffix
        window = child.slice(base, end - base)
        if isinstance(window, (ListColumn, MapColumn, FixedSizeListColumn)):
            out.extend(_flatten_list_chain(cname, window, chain, valids, dtype))
        elif isinstance(window, StructColumn):
            for sub, f in zip(window.children, window.dtype):
                leaf = f"{cname}.{f.name}"
                if isinstance(sub, PrimitiveColumn) and sub.values.ndim == 1:
                    out.append(
                        _emit_list_leaf(leaf, dtype, chain, valids, sub)
                    )
                elif isinstance(sub, BinaryColumn):
                    out.append(
                        _binary_leaf_device(leaf, sub, dtype, chain, valids)
                    )
                else:
                    raise NotYetImplementedError(
                        f"device layout for list<struct> field {leaf!r}"
                    )
        elif isinstance(window, PrimitiveColumn) and window.values.ndim == 1:
            out.append(_emit_list_leaf(cname, dtype, chain, valids, window))
        elif isinstance(window, BinaryColumn):
            out.append(_binary_leaf_device(cname, window, dtype, chain, valids))
        else:
            raise NotYetImplementedError(
                f"device layout for nested column {cname!r} "
                f"({type(window).__name__} leaf)"
            )
    return out


def _compose_offsets(chain) -> np.ndarray:
    """chain outer→inner, each zero-based → composed row→leaf offsets."""
    comp = chain[0]
    for inner in chain[1:]:
        comp = inner[comp]
    return comp


def _emit_list_leaf(name, dtype, chain, valids, leaf) -> "DeviceListColumn":
    comp = _compose_offsets(chain).astype(np.int32)
    exact = (
        np.asarray(leaf.values)
        if leaf.values.dtype == np.float64
        else None
    )
    return DeviceListColumn(
        name,
        dtype,
        jnp.asarray(leaf.values),
        jnp.asarray(valids[0]) if valids[0] is not None else None,
        None,
        host_exact=exact,
        offsets=jnp.asarray(comp),
        child_validity=(
            jnp.asarray(leaf.validity) if leaf.validity is not None else None
        ),
        offsets_stack=tuple(np.asarray(o, dtype=np.int32) for o in chain),
        list_validities=tuple(valids),
    )


def _binary_leaf_device(name, col, dtype, chain, valids):
    """Binary/utf8 leaf → dictionary codes (+ optional list offsets)."""
    enc = col.to_arrow().dictionary_encode()
    codes = jnp.asarray(
        enc.indices.to_numpy(zero_copy_only=False).astype(np.int32)
    )
    cvalid = (
        jnp.asarray(col.validity) if col.validity is not None else None
    )
    if chain is None:
        return DeviceColumn(name, dtype, codes, cvalid, enc.dictionary)
    comp = _compose_offsets(chain).astype(np.int32)
    return DeviceListColumn(
        name,
        dtype,
        codes,
        jnp.asarray(valids[0]) if valids[0] is not None else None,
        enc.dictionary,
        offsets=jnp.asarray(comp),
        child_validity=cvalid,
        offsets_stack=tuple(np.asarray(o, dtype=np.int32) for o in chain),
        list_validities=tuple(valids),
    )


def scan_chunks(
    path: str,
    chunk_pages: int,
    columns: Optional[Sequence[str]] = None,
    predicates: Optional[Sequence] = None,
):
    """Stream a file as a sequence of DeviceTables of ``chunk_pages`` pages.

    For tables larger than HBM: each chunk decodes independently (page-grid
    aligned across columns), so callers can feed a chunked pipeline
    (``parallel.pipelined_distributed_aggregate``) or reduce incrementally.
    """
    with open(path, "rb") as f:
        schema = infer_schema(f)
        metas = read_meta(f)
    n_pages = max((len(m.pages) for m in metas), default=0)
    base_keep = None
    if predicates:
        from .pruning import prune_pages, read_zones

        zones = read_zones(path)
        if zones:
            base_keep = prune_pages(zones, predicates, n_pages)
    # mmap: compressed bytes stream straight from page cache into the
    # native decompressors — no up-front whole-file read
    file_bytes = np.memmap(path, dtype=np.uint8, mode="r")
    for start in range(0, n_pages, chunk_pages):
        stop = min(start + chunk_pages, n_pages)
        keep = np.zeros(n_pages, dtype=bool)
        keep[start:stop] = True
        if base_keep is not None:
            keep &= base_keep
        if not keep.any():
            continue
        out: Dict[str, DeviceColumn] = {}
        num_rows = 0
        i = 0
        for field in schema:
            n = n_leaf_columns(field.type)
            meta = metas[i]
            i += n
            if columns is not None and field.name not in columns:
                continue
            if not is_primitive(field.type) or pa.types.is_null(field.type):
                # nested columns decode the chunk's kept pages host-side and
                # flatten like scan_file — a chunked scan must never return
                # fewer columns than a whole-file scan
                from ..read.batch_read import batch_read_column
                from ..read.reader import open_readers_subset

                readers = open_readers_subset(path, metas[i - n : i], keep)
                host_col = batch_read_column(readers, field)
                for r in readers:
                    r.page_reader.close()
                last = None
                for dc in _flatten_nested_device(field.name, host_col):
                    out[dc.name] = dc
                    last = dc
                if last is not None and not isinstance(last, DeviceListColumn):
                    num_rows = len(last)
                continue
            if (
                pa.types.is_string(field.type)
                or pa.types.is_binary(field.type)
                or pa.types.is_large_string(field.type)
                or pa.types.is_large_binary(field.type)
            ):
                col = _decode_binary_column_device(file_bytes, meta, field, keep)
            elif pa.types.is_decimal(field.type):
                col = _decode_decimal_column_device(file_bytes, meta, field, keep)
            else:
                col = decode_column_pages_device(file_bytes, meta, field, keep)
            out[field.name] = col
            num_rows = len(col)
        yield DeviceTable(out, num_rows)


def scan_file(
    path: str,
    columns: Optional[Sequence[str]] = None,
    predicates: Optional[Sequence] = None,
) -> DeviceTable:
    """Scan a strawboat file into device-resident columns.

    ``predicates``: optional list of ``pruning.Comparison`` atoms — when a
    zone-map sidecar exists, pages that cannot match are seek-skipped for
    every scanned column (the row grid stays aligned).
    Simple primitive columns decode on device; binary/nested columns fall
    back to the host reader (device layouts for those come with the string
    kernels).
    """
    with open(path, "rb") as f:
        schema = infer_schema(f)
        metas = read_meta(f)
    # mmap: compressed bytes stream straight from page cache into the
    # native decompressors — no up-front whole-file read
    file_bytes = np.memmap(path, dtype=np.uint8, mode="r")
    keep = None
    if predicates:
        from .pruning import prune_pages, read_zones

        zones = read_zones(path)
        if zones:
            n_pages = max(len(m.pages) for m in metas)
            keep = prune_pages(zones, predicates, n_pages)
            if keep.all():
                keep = None
    out: Dict[str, DeviceColumn] = {}
    num_rows = 0
    i = 0
    for field in schema:
        n = n_leaf_columns(field.type)
        meta = metas[i]
        i += n
        if columns is not None and field.name not in columns:
            continue
        if not is_primitive(field.type) or pa.types.is_null(field.type):
            # nested columns: host-decode then flatten to device representation
            # (list<numeric> → offsets + flat child; struct → dotted children)
            from ..read.batch_read import batch_read_column
            from ..read.reader import open_readers, open_readers_subset

            readers = (
                open_readers_subset(path, metas[i - n : i], keep)
                if keep is not None
                else open_readers(path, metas[i - n : i])
            )
            host_col = batch_read_column(readers, field)
            for r in readers:
                r.page_reader.close()
            for dc in _flatten_nested_device(field.name, host_col):
                out[dc.name] = dc
            continue
        if (
            pa.types.is_string(field.type)
            or pa.types.is_binary(field.type)
            or pa.types.is_large_string(field.type)
            or pa.types.is_large_binary(field.type)
        ):
            col = _decode_binary_column_device(file_bytes, meta, field, keep)
            out[field.name] = col
            num_rows = len(col)
            continue
        if pa.types.is_decimal(field.type):
            col = _decode_decimal_column_device(file_bytes, meta, field, keep)
            out[field.name] = col
            num_rows = len(col)
            continue
        col = decode_column_pages_device(file_bytes, meta, field, keep)
        out[field.name] = col
        num_rows = len(col)
    return DeviceTable(out, num_rows)
