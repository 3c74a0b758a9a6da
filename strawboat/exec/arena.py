"""Pooled host staging arenas for decode→upload.

Decoded page bytes land in a reusable pinned-style host buffer and stream to
device memory in chunks, so a warm scan pays neither fresh-allocation page faults
(~0.7 s / 134 MB on small-vCPU hosts) nor an extra concatenate pass.  An
arena is recycled only after every device array whose transfer read from it
is ready (``block_until_ready``), which makes reuse correct even when
``device_put`` is asynchronous.

The device-side analogue of the reference's page-buffer recycling
(``PageIterator::swap_buffer``, src/read/mod.rs:26-57) — scaled up from one
page to one column, because the transfer granularity that saturates the host
link is tens of MB, not one page (the chunk size for PCIe on the H100 is
still to be measured: ROADMAP S3).
"""

from __future__ import annotations

import threading
from typing import List, Tuple

import numpy as np

_lock = threading.Lock()
_pool: List[Tuple[np.ndarray, list]] = []  # (buffer, inflight device arrays)
_MAX_POOLED = 4


def acquire(nbytes: int) -> np.ndarray:
    """Return a uint8 buffer of at least ``nbytes`` (a view of exactly
    ``nbytes``); pre-touched when recycled, so writes take no page faults."""
    with _lock:
        best = None
        for i, (buf, _inflight) in enumerate(_pool):
            if buf.size >= nbytes and (best is None or buf.size < _pool[best][0].size):
                best = i
        if best is not None:
            buf, inflight = _pool.pop(best)
        else:
            buf, inflight = None, []
    for arr in inflight:
        # a deleted array's transfer has finished reading this buffer
        if not arr.is_deleted():
            arr.block_until_ready()
    if buf is None:
        buf = np.empty(max(nbytes, 1 << 20), dtype=np.uint8)
    return buf[:nbytes]


def release(view: np.ndarray, inflight) -> None:
    """Return an arena to the pool.  ``inflight``: device arrays whose
    host→device transfer reads from this buffer; reuse waits on them."""
    base = view.base if view.base is not None else view
    if not isinstance(base, np.ndarray) or base.dtype != np.uint8:
        return
    with _lock:
        if len(_pool) >= _MAX_POOLED:
            # drop the smallest pooled buffer to bound host memory
            smallest = min(range(len(_pool)), key=lambda i: _pool[i][0].size)
            if _pool[smallest][0].size < base.size:
                _pool.pop(smallest)
            else:
                return
        _pool.append((base, list(inflight)))


def clear() -> None:
    with _lock:
        _pool.clear()
