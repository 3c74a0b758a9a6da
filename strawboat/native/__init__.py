"""Native host runtime loader: builds (once per source and host) and binds
libstrawboat_native.

The library is compiled from the committed ``strawboat_native.cpp`` on the
machine that loads it, into ``build/<key>/`` beside the source, where the
key hashes the source, the compiler, and the host's CPU model and flags: a
library built for another machine is never loaded.  The general codecs it
calls (liblz4 / libzstd / libsnappy) are linked only where present; a
missing one fails that codec's calls, not the build.  Callers check
``available()`` and use the pure numpy/ctypes paths otherwise;
``load_error()`` says why the library is unavailable.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import platform
import subprocess
import threading
from typing import Optional

import numpy as np

_HERE = os.path.dirname(os.path.abspath(__file__))
_SRC = os.path.join(_HERE, "strawboat_native.cpp")
_CODEC_LIBS = ("liblz4.so.1", "libzstd.so.1", "libsnappy.so.1")

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_tried = False
_error: Optional[str] = None


def _host_id() -> bytes:
    """CPU model and feature flags (what ``-march=native`` compiles for)."""
    parts = [platform.machine()]
    try:
        with open("/proc/cpuinfo") as f:
            for line in f:
                if line.startswith(("model name", "flags")):
                    parts.append(line.strip())
                if len(parts) == 3:
                    break
    except OSError:
        pass
    return "\n".join(parts).encode()


def _present_codec_libs():
    out = []
    for name in _CODEC_LIBS:
        try:
            ctypes.CDLL(name)
        except OSError:
            continue
        out.append(name)
    return out


def _so_path(libs) -> str:
    h = hashlib.sha256()
    with open(_SRC, "rb") as f:
        h.update(f.read())
    try:
        cc = subprocess.run(
            ["g++", "--version"], capture_output=True, timeout=30
        ).stdout
    except (OSError, subprocess.SubprocessError):
        cc = b""
    h.update(cc)
    h.update(_host_id())
    h.update(",".join(libs).encode())
    return os.path.join(
        _HERE, "build", h.hexdigest()[:16], "libstrawboat_native.so"
    )


def _build(so: str, libs) -> Optional[str]:
    """Compile into ``so``; returns None on success, else the reason."""
    os.makedirs(os.path.dirname(so), exist_ok=True)
    tmp = f"{so}.{os.getpid()}.tmp"
    cmd = [
        "g++", "-O3", "-march=native", "-shared", "-fPIC", "-std=c++17",
        _SRC, "-o", tmp,
        # every codec reference is weak: keep the libraries linked anyway
        "-Wl,--no-as-needed",
    ] + [f"-l:{name}" for name in libs] + ["-lpthread"]
    try:
        subprocess.run(cmd, check=True, capture_output=True, timeout=300)
    except subprocess.CalledProcessError as e:
        return f"g++ failed: {e.stderr.decode(errors='replace')[-400:]}"
    except (OSError, subprocess.SubprocessError) as e:
        return f"g++ not runnable: {e}"
    os.replace(tmp, so)  # atomic: concurrent builders never see a torn file
    return None


def load_error() -> Optional[str]:
    """Why the native library is unavailable (None when it loaded)."""
    _load()
    return _error


def _load() -> Optional[ctypes.CDLL]:
    global _lib, _tried, _error
    with _lock:
        if _lib is not None or _tried:
            return _lib
        _tried = True
        libs = _present_codec_libs()
        so = _so_path(libs)
        if not os.path.exists(so):
            _error = _build(so, libs)
            if _error is not None:
                return None
        try:
            lib = ctypes.CDLL(so)
        except OSError as e:
            _error = f"load failed: {e}"
            return None
        lib.sb_decompress_batch.restype = ctypes.c_int
        lib.sb_decompress_batch.argtypes = [
            ctypes.c_int,
            ctypes.c_int64,
            ctypes.POINTER(ctypes.c_void_p),
            ctypes.POINTER(ctypes.c_int64),
            ctypes.POINTER(ctypes.c_void_p),
            ctypes.POINTER(ctypes.c_int64),
            ctypes.c_int,
        ]
        lib.sb_compress.restype = ctypes.c_int64
        lib.sb_compress.argtypes = [
            ctypes.c_int,
            ctypes.c_void_p,
            ctypes.c_int64,
            ctypes.c_void_p,
            ctypes.c_int64,
        ]
        lib.sb_compress_bound.restype = ctypes.c_int64
        lib.sb_compress_bound.argtypes = [ctypes.c_int, ctypes.c_int64]
        lib.sb_patas_decode.restype = ctypes.c_int
        lib.sb_patas_decode.argtypes = [
            ctypes.c_void_p,
            ctypes.c_int64,
            ctypes.c_int64,
            ctypes.c_int,
            ctypes.c_void_p,
        ]
        lib.sb_patas_encode.restype = ctypes.c_int64
        lib.sb_patas_encode.argtypes = [
            ctypes.c_void_p,
            ctypes.c_int64,
            ctypes.c_int,
            ctypes.c_void_p,
        ]
        for fn in (
            lib.sb_int_stats_i64,
            lib.sb_int_stats_u64,
            lib.sb_int_stats_i32,
            lib.sb_int_stats_u32,
            lib.sb_int_stats_i16,
            lib.sb_int_stats_u16,
            lib.sb_int_stats_i8,
            lib.sb_int_stats_u8,
        ):
            fn.restype = ctypes.c_int
            fn.argtypes = [
                ctypes.c_void_p,
                ctypes.c_void_p,
                ctypes.c_int64,
                ctypes.c_void_p,
            ]
        lib.sb_bp_walk.restype = ctypes.c_int64
        lib.sb_bp_walk.argtypes = [
            ctypes.c_void_p,
            ctypes.c_int64,
            ctypes.c_int64,
            ctypes.c_int64,
            ctypes.c_void_p,
        ]
        lib.sb_bp_decode.restype = ctypes.c_int64
        lib.sb_bp_decode.argtypes = [
            ctypes.c_void_p,
            ctypes.c_int64,
            ctypes.c_int64,
            ctypes.c_int64,
            ctypes.c_void_p,
        ]
        lib.sb_bp_encode.restype = ctypes.c_int64
        lib.sb_bp_encode.argtypes = [
            ctypes.c_void_p,
            ctypes.c_int64,
            ctypes.c_void_p,
            ctypes.c_void_p,
        ]
        for fn in (lib.sb_factorize_u64, lib.sb_factorize_u32):
            fn.restype = ctypes.c_int64
            fn.argtypes = [
                ctypes.c_void_p,
                ctypes.c_int64,
                ctypes.c_void_p,
                ctypes.c_void_p,
                ctypes.c_int64,
            ]
        lib.sb_dict_column_decode.restype = ctypes.c_int
        lib.sb_dict_column_decode.argtypes = [
            ctypes.POINTER(ctypes.c_void_p),
            ctypes.POINTER(ctypes.c_int64),
            ctypes.POINTER(ctypes.c_int64),
            ctypes.POINTER(ctypes.c_int64),
            ctypes.POINTER(ctypes.c_int64),
            ctypes.POINTER(ctypes.c_int64),
            ctypes.c_void_p,
            ctypes.c_int64,
            ctypes.c_void_p,
            ctypes.c_int64,
            ctypes.c_int,
            ctypes.c_void_p,
            ctypes.c_int,
        ]
        _lib = lib
        return _lib


def available() -> bool:
    return _load() is not None


def decompress_batch(codec: int, inputs, out_lens, n_threads: int = 0):
    """Decompress a batch of pages in parallel native threads.

    inputs: list of (bytes|memoryview|np.uint8 array); out_lens: list of int.
    Returns list of np.uint8 arrays.
    """
    lib = _load()
    assert lib is not None
    n = len(inputs)
    outs = [np.empty(int(L), dtype=np.uint8) for L in out_lens]
    in_bufs = [np.frombuffer(b, dtype=np.uint8) if not isinstance(b, np.ndarray) else b for b in inputs]
    in_ptrs = (ctypes.c_void_p * n)(
        *[b.ctypes.data_as(ctypes.c_void_p).value for b in in_bufs]
    )
    in_lens = (ctypes.c_int64 * n)(*[b.size for b in in_bufs])
    out_ptrs = (ctypes.c_void_p * n)(
        *[o.ctypes.data_as(ctypes.c_void_p).value for o in outs]
    )
    out_lens_c = (ctypes.c_int64 * n)(*[o.size for o in outs])
    rc = lib.sb_decompress_batch(
        codec,
        n,
        ctypes.cast(in_ptrs, ctypes.POINTER(ctypes.c_void_p)),
        in_lens,
        ctypes.cast(out_ptrs, ctypes.POINTER(ctypes.c_void_p)),
        out_lens_c,
        n_threads,
    )
    if rc != 0:
        from ..errors import OutOfSpecError

        raise OutOfSpecError(f"native batch decompression failed (rc={rc})")
    return outs


def decompress_batch_into(
    codec: int,
    inputs,
    out_buf: np.ndarray,
    out_offsets,
    out_lens,
    n_threads: int = 0,
) -> None:
    """Decompress pages in parallel directly into one contiguous buffer.

    Each page ``i`` decodes to ``out_buf[out_offsets[i]:+out_lens[i]]`` —
    no per-page allocation, no concatenate pass.  ``out_buf`` must be a
    C-contiguous uint8 array large enough for every slice.
    """
    lib = _load()
    assert lib is not None
    n = len(inputs)
    in_bufs = [
        np.frombuffer(b, dtype=np.uint8) if not isinstance(b, np.ndarray) else b
        for b in inputs
    ]
    base = out_buf.ctypes.data_as(ctypes.c_void_p).value
    in_ptrs = (ctypes.c_void_p * n)(
        *[b.ctypes.data_as(ctypes.c_void_p).value for b in in_bufs]
    )
    in_lens = (ctypes.c_int64 * n)(*[b.size for b in in_bufs])
    out_ptrs = (ctypes.c_void_p * n)(
        *[base + int(off) for off in out_offsets]
    )
    out_lens_c = (ctypes.c_int64 * n)(*[int(L) for L in out_lens])
    rc = lib.sb_decompress_batch(
        codec,
        n,
        ctypes.cast(in_ptrs, ctypes.POINTER(ctypes.c_void_p)),
        in_lens,
        ctypes.cast(out_ptrs, ctypes.POINTER(ctypes.c_void_p)),
        out_lens_c,
        n_threads,
    )
    if rc != 0:
        from ..errors import OutOfSpecError

        raise OutOfSpecError(f"native batch decompression failed (rc={rc})")


def bp_walk(buf: np.ndarray, body: int, n_blocks: int):
    """Walk bitpacked block headers → (nbs u8 array, end offset).

    Native when available (the per-block Python loop costs ~1us/block);
    pure-Python fallback otherwise.  Raises on truncated input.
    """
    lib = _load()
    if lib is not None:
        nbs = np.empty(n_blocks, dtype=np.uint8)
        end = lib.sb_bp_walk(
            buf.ctypes.data_as(ctypes.c_void_p),
            buf.size,
            body,
            n_blocks,
            nbs.ctypes.data_as(ctypes.c_void_p),
        )
        if end < 0:
            from ..errors import OutOfSpecError

            raise OutOfSpecError("bitpacked page truncated")
        return nbs, int(end)
    nbs = np.empty(n_blocks, dtype=np.uint8)
    p = body
    for i in range(n_blocks):
        if p >= buf.size:
            from ..errors import OutOfSpecError

            raise OutOfSpecError("bitpacked page truncated")
        nb = int(buf[p])
        nbs[i] = nb
        p += 1 + nb * 16
    return nbs, p


def bp_decode(buf: np.ndarray, pos: int, n_blocks: int):
    """Decode a whole bitpacked page (mixed widths OK) in one C pass.

    Returns (values u32 array of n_blocks*128, end offset) or None when the
    native runtime is unavailable.  Raises on truncated input.
    """
    lib = _load()
    if lib is None:
        return None
    if not isinstance(buf, np.ndarray):
        buf = np.frombuffer(buf, dtype=np.uint8)
    out = np.empty(n_blocks * 128, dtype=np.uint32)
    end = lib.sb_bp_decode(
        buf.ctypes.data_as(ctypes.c_void_p),
        buf.size,
        pos,
        n_blocks,
        out.ctypes.data_as(ctypes.c_void_p),
    )
    if end < 0:
        from ..errors import OutOfSpecError

        raise OutOfSpecError("bitpacked page truncated")
    return out, int(end)


def bp_encode(
    payload_blocks: np.ndarray, width_blocks: np.ndarray
) -> "Optional[bytes]":
    """Encode (n, 128) u32 blocks as [u8 nb][packed]* in one C pass."""
    lib = _load()
    if lib is None or not hasattr(lib, "sb_bp_encode"):
        return None
    n_blocks = payload_blocks.shape[0]
    payload_blocks = np.ascontiguousarray(payload_blocks, dtype=np.uint32)
    width_blocks = np.ascontiguousarray(width_blocks, dtype=np.uint32)
    out = np.empty(n_blocks * (1 + 32 * 16), dtype=np.uint8)
    written = lib.sb_bp_encode(
        payload_blocks.ctypes.data_as(ctypes.c_void_p),
        n_blocks,
        width_blocks.ctypes.data_as(ctypes.c_void_p),
        out.ctypes.data_as(ctypes.c_void_p),
    )
    return out[:written].tobytes()


def factorize(values: np.ndarray, max_uniq: int = 1 << 62):
    """First-occurrence factorization of a u32/u64 array via one C pass.

    Returns (codes u32, uniq) or None (native unavailable / dtype
    unsupported / unique count exceeds ``max_uniq``).
    """
    lib = _load()
    if lib is None or values.dtype not in (np.uint64, np.uint32):
        return None
    values = np.ascontiguousarray(values)
    n = len(values)
    codes = np.empty(n, dtype=np.uint32)
    uniq = np.empty(min(n, max_uniq) if n else 1, dtype=values.dtype)
    fn = (
        lib.sb_factorize_u64
        if values.dtype == np.uint64
        else lib.sb_factorize_u32
    )
    n_uniq = fn(
        values.ctypes.data_as(ctypes.c_void_p),
        n,
        codes.ctypes.data_as(ctypes.c_void_p),
        uniq.ctypes.data_as(ctypes.c_void_p),
        int(min(max_uniq, max(n, 1))),
    )
    if n_uniq < 0:
        return None
    return codes, uniq[:n_uniq]


def dict_column_decode(
    pages, dict_values: np.ndarray, out: np.ndarray, n_threads: int = 0
) -> None:
    """Fused all-DICT column decode: codes + gather, threaded over pages.

    pages: list of (buf u8 array, body offset | None, num_values, row_offset,
    base, kind) where kind 0 = bitpacked codes at body, 1 = buf points at raw
    u32 codes, 2 = bitpacked deltas.  ``out`` must be C-contiguous with
    itemsize in {1,2,4,8} and dtype layout equal to ``dict_values``.
    """
    lib = _load()
    assert lib is not None
    n = len(pages)
    bufs = [p[0] for p in pages]
    buf_ptrs = (ctypes.c_void_p * n)(
        *[b.ctypes.data_as(ctypes.c_void_p).value for b in bufs]
    )
    buf_lens = (ctypes.c_int64 * n)(*[b.size for b in bufs])
    bodies = (ctypes.c_int64 * n)(*[int(p[1] or 0) for p in pages])
    n_values = (ctypes.c_int64 * n)(*[int(p[2]) for p in pages])
    row_offsets = (ctypes.c_int64 * n)(*[int(p[3]) for p in pages])
    bases = (ctypes.c_int64 * n)(*[int(p[4]) for p in pages])
    kinds = (ctypes.c_uint8 * n)(*[int(p[5]) for p in pages])
    rc = lib.sb_dict_column_decode(
        ctypes.cast(buf_ptrs, ctypes.POINTER(ctypes.c_void_p)),
        buf_lens,
        bodies,
        n_values,
        row_offsets,
        bases,
        ctypes.cast(kinds, ctypes.c_void_p),
        n,
        dict_values.ctypes.data_as(ctypes.c_void_p),
        len(dict_values),
        dict_values.dtype.itemsize,
        out.ctypes.data_as(ctypes.c_void_p),
        n_threads,
    )
    if rc != 0:
        from ..errors import OutOfSpecError

        raise OutOfSpecError(f"native dict column decode failed (rc={rc})")


def int_stats_native(values: np.ndarray, validity: Optional[np.ndarray]):
    """One-pass page stats via C++ (reference gen_stats hot loop)."""
    lib = _load()
    if lib is None:
        return None
    dtype = values.dtype
    # stats run straight off the storage width (no astype copy per page)
    fn = getattr(
        lib, f"sb_int_stats_{dtype.kind}{dtype.itemsize * 8}", None
    )
    if fn is None:
        return None
    v = np.ascontiguousarray(values)
    vmask = (
        np.ascontiguousarray(validity, dtype=np.uint8)
        if validity is not None
        else None
    )
    out = np.zeros(8, dtype=np.int64)
    fn(
        v.ctypes.data_as(ctypes.c_void_p),
        vmask.ctypes.data_as(ctypes.c_void_p) if vmask is not None else None,
        len(v),
        out.ctypes.data_as(ctypes.c_void_p),
    )
    from ..codecs._family import FamilyStats

    n = len(values)
    run_count = int(out[3])
    vmin = out[0] if dtype.kind == "i" else np.uint64(out[0].view(np.uint64))
    vmax = out[1] if dtype.kind == "i" else np.uint64(out[1].view(np.uint64))
    top = np.asarray(out[6]).view(np.uint64)[()] if dtype.kind == "u" else out[6]
    return FamilyStats(
        values=values,
        validity=validity,
        tuple_count=n,
        total_bytes=n * dtype.itemsize,
        null_count=int(out[2]),
        average_run_length=(n / run_count) if run_count else float("inf"),
        is_sorted=bool(out[4]),
        min=dtype.type(vmin),
        max=dtype.type(vmax),
        unique_count=int(out[5]),
        top_value=dtype.type(top),
        max_count=int(out[7]),
        set_count=n - int(out[2]),
    )


def patas_decode_native(buf: np.ndarray, pos: int, length: int, dtype) -> Optional[np.ndarray]:
    lib = _load()
    if lib is None:
        return None
    dtype = np.dtype(dtype)
    width = dtype.itemsize
    out = np.empty(length, dtype=np.uint64)
    src = np.ascontiguousarray(buf[pos:])
    rc = lib.sb_patas_decode(
        src.ctypes.data_as(ctypes.c_void_p),
        src.size,
        length,
        width,
        out.ctypes.data_as(ctypes.c_void_p),
    )
    if rc != 0:
        from ..errors import OutOfSpecError

        raise OutOfSpecError(f"native patas decode failed (rc={rc})")
    return out.astype(f"<u{width}").view(dtype)


def patas_encode_native(values: np.ndarray) -> Optional[bytes]:
    lib = _load()
    if lib is None:
        return None
    dtype = values.dtype
    width = dtype.itemsize
    bits = values.view(f"<u{width}").astype(np.uint64)
    n = len(bits)
    if n == 0:
        return b""
    out = np.empty(n * (width + 2) + width, dtype=np.uint8)
    written = lib.sb_patas_encode(
        bits.ctypes.data_as(ctypes.c_void_p),
        n,
        width,
        out.ctypes.data_as(ctypes.c_void_p),
    )
    if written < 0:
        return None
    return out[:written].tobytes()
