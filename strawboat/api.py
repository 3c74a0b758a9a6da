"""High-level convenience API (the examples/*.rs equivalents)."""

from __future__ import annotations

from typing import Iterator, List, Optional

import pyarrow as pa

from .meta import ColumnMeta
from .read.batch_read import batch_read_column
from .read.deserialize import column_iter_to_arrays
from .read.reader import infer_schema, open_readers, read_meta
from .schema import n_leaf_columns
from .write.writer import NativeWriter, write_file  # noqa: F401


def split_metas_by_field(schema: pa.Schema, metas: List[ColumnMeta]) -> List[List[ColumnMeta]]:
    out = []
    i = 0
    for field in schema:
        n = n_leaf_columns(field.type)
        out.append(metas[i : i + n])
        i += n
    return out


def _field_readers(path: str, schema: pa.Schema, metas: List[ColumnMeta]):
    per_field = split_metas_by_field(schema, metas)
    for field, field_metas in zip(schema, per_field):
        yield field, open_readers(path, field_metas)


def read_table(
    path: str, columns: Optional[List[str]] = None, arena=None
) -> pa.Table:
    """Whole-file batch read → pyarrow Table (strawboat_batch_read.rs).

    Simple fixed-width columns with all-common-codec pages take the planned
    fast path (one native threaded batch-decompress into the final buffer,
    zero-copy arrow wrap); everything else streams through the general
    per-page reader.

    ``arena`` (a :class:`strawboat.read.fast.ReadArena`) recycles the
    decoded values buffers across calls — the batch-read analogue of the
    reference's ``PageIterator::swap_buffer`` page-buffer recycling.  Arrays
    from the PREVIOUS read with the same arena are invalidated.
    """
    import numpy as np

    from .read.fast import read_column_fast

    with open(path, "rb") as f:
        schema = infer_schema(f)
        metas = read_meta(f)
    file_bytes = np.memmap(path, dtype=np.uint8, mode="r")
    per_field = split_metas_by_field(schema, metas)
    if arena is not None:
        arena.recycle()
    work = [
        (field, field_metas)
        for field, field_metas in zip(schema, per_field)
        if columns is None or field.name in columns
    ]

    from .read.fast import read_binary_column_fast

    def _one(field, field_metas):
        arr = None
        if len(field_metas) == 1:
            arr = read_column_fast(
                file_bytes, field_metas[0], field, arena=arena
            )
            if arr is None:
                arr = read_binary_column_fast(file_bytes, field_metas[0], field)
        if arr is None:
            readers = open_readers(path, field_metas)
            arr = batch_read_column(readers, field).to_arrow()
            for r in readers:
                r.page_reader.close()
        return arr

    if len(work) > 1:
        # columns decode concurrently: the hot loops (native decompress,
        # numpy gathers/bit ops) release the GIL, so this scales on cores
        # like the reference's Send+Sync per-column drive in Databend
        import concurrent.futures as cf
        import os as _os

        with cf.ThreadPoolExecutor(
            max_workers=min(len(work), _os.cpu_count() or 2)
        ) as pool:
            arrays = list(pool.map(lambda w: _one(*w), work))
    else:
        arrays = [_one(f, m) for f, m in work]
    fields = [f for f, _m in work]
    return pa.Table.from_arrays(arrays, schema=pa.schema(fields))


def iter_batches(path: str) -> Iterator[pa.RecordBatch]:
    """Streaming page-wise read → RecordBatch per page (strawboat_read.rs)."""
    with open(path, "rb") as f:
        schema = infer_schema(f)
        metas = read_meta(f)
    iters = []
    all_readers = []
    for field, readers in _field_readers(path, schema, metas):
        iters.append((field, column_iter_to_arrays(readers, field)))
        all_readers.extend(readers)
    try:
        while True:
            cols = []
            for field, it in iters:
                col = next(it, None)
                if col is None:
                    return
                cols.append(col.to_arrow())
            yield pa.RecordBatch.from_arrays(cols, schema=schema)
    finally:
        for r in all_readers:
            r.page_reader.close()
