"""Footer/meta tests (mirrors tests/it/read_meta.rs:60-97): metas written ==
metas re-read, sync and async, with and without total_len."""

import asyncio

import pyarrow as pa
import pytest

from conftest import create_random_i64
from strawboat.api import write_file
from strawboat.codecs import WriteOptions
from strawboat.constants import Compression
from strawboat.read.reader import (
    infer_schema,
    infer_schema_async,
    read_meta,
    read_meta_async,
)


class _AsyncFile:
    def __init__(self, path):
        self.path = path

    async def size(self):
        import os

        return os.path.getsize(self.path)

    async def read_at(self, offset, length):
        with open(self.path, "rb") as f:
            f.seek(offset)
            return f.read(length)


def _write(path):
    table = pa.table(
        {"a": create_random_i64(5000, 0.1), "b": create_random_i64(5000, 0.0)}
    )
    metas = write_file(
        path,
        table,
        options=WriteOptions(
            default_compression=Compression.LZ4, max_page_size=1024
        ),
    )
    return table, metas


def test_read_meta_sync(tmp_strawboat):
    table, metas = _write(tmp_strawboat)
    with open(tmp_strawboat, "rb") as f:
        got = read_meta(f)
    assert got == metas
    with open(tmp_strawboat, "rb") as f:
        schema = infer_schema(f)
    assert schema.equals(table.schema)


@pytest.mark.parametrize("with_len", [True, False])
def test_read_meta_async(tmp_strawboat, with_len):
    import os

    _, metas = _write(tmp_strawboat)
    total = os.path.getsize(tmp_strawboat) if with_len else None
    got = asyncio.run(read_meta_async(_AsyncFile(tmp_strawboat), total))
    assert got == metas


def test_infer_schema_async(tmp_strawboat):
    table, _ = _write(tmp_strawboat)
    schema = asyncio.run(infer_schema_async(_AsyncFile(tmp_strawboat)))
    assert schema.equals(table.schema)


def test_meta_slicing(tmp_strawboat):
    _, metas = _write(tmp_strawboat)
    m = metas[0]
    s = m.slice(1, len(m.pages))
    assert s.offset == m.offset + m.pages[0].length
    assert s.pages == m.pages[1:]
    assert m.skip_one_page() == s
    assert m.total_len() == sum(p.length for p in m.pages)


def test_page_iterator_nth_and_skip(tmp_strawboat):
    """Page skipping seeks without reading (reference reader.rs:91-147)."""
    import numpy as np

    from strawboat.read.deserialize import decode_simple_page
    from strawboat.read.reader import open_readers

    table, metas = _write(tmp_strawboat)
    field = table.schema.field(0)
    # nth(2): skip pages 0-1, read page 2
    readers = open_readers(tmp_strawboat, metas[:1])
    nv, buf = readers[0].nth(2)
    col = decode_simple_page(field, int(nv), buf)
    start = 2 * 1024
    exp = table.column(0).to_pylist()[start : start + int(nv)]
    assert col.to_arrow().to_pylist() == exp
    # skip_page then next
    readers2 = open_readers(tmp_strawboat, metas[:1])
    readers2[0].skip_page()
    nv2, buf2 = next(readers2[0])
    col2 = decode_simple_page(field, int(nv2), buf2)
    exp2 = table.column(0).to_pylist()[1024 : 1024 + int(nv2)]
    assert col2.to_arrow().to_pylist() == exp2
    for r in readers + readers2:
        r.page_reader.close()
