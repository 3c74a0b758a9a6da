"""Stat-tree parsing tests (mirrors src/stat.rs:174-270 inline tests,
including env-forced Dict/Freq page shapes)."""

import numpy as np
import pyarrow as pa
import pytest

from strawboat.api import write_file
from strawboat.codecs import WriteOptions
from strawboat.constants import Compression
from strawboat.read.reader import open_readers, read_meta
from strawboat.stat import stat_simple
from strawboat.util import env


@pytest.fixture(autouse=True)
def _clean_env():
    env.remove_all_env()
    yield
    env.remove_all_env()


def _stat_for(tmp, table, opts):
    metas = write_file(tmp, table, options=opts)
    readers = open_readers(tmp, metas)
    info = stat_simple(readers[0], table.schema.field(0))
    for r in readers:
        r.page_reader.close()
    return info


def test_stat_common(tmp_strawboat):
    schema = pa.schema([pa.field("a", pa.int64(), nullable=False)])
    table = pa.table({"a": pa.array(np.arange(5000, dtype=np.int64))}, schema=schema)
    info = _stat_for(
        tmp_strawboat,
        table,
        WriteOptions(default_compression=Compression.LZ4, max_page_size=2048),
    )
    assert len(info.pages) == 3
    for p in info.pages:
        assert p.body.kind == "common"
        assert p.body.common == Compression.LZ4
        assert p.validity_size is None


def test_stat_dict_forced(tmp_strawboat, monkeypatch):
    monkeypatch.setenv(env.DICT_ENV, "1")
    table = pa.table(
        {"a": pa.array([int(i % 4) if i % 7 else None for i in range(4000)], type=pa.int64())}
    )
    info = _stat_for(
        tmp_strawboat,
        table,
        WriteOptions(default_compression=Compression.LZ4, max_page_size=2048),
    )
    p = info.pages[0]
    assert p.body.kind == "dict"
    assert p.body.dict.unique_num == 4
    assert p.validity_size is not None
    assert p.body.dict.indices.body.kind in ("common", "rle", "bitpack", "one_value")


def test_stat_freq_forced(tmp_strawboat, monkeypatch):
    monkeypatch.setenv(env.FREQ_ENV, "1")
    vals = np.full(4000, 1 << 20, dtype=np.int64)
    vals[::100] = 7
    table = pa.table({"a": pa.array(vals)})
    info = _stat_for(
        tmp_strawboat,
        table,
        WriteOptions(default_compression=Compression.LZ4, max_page_size=2048),
    )
    p = info.pages[0]
    assert p.body.kind == "freq"
    assert p.body.freq.exceptions_bitmap_size > 0
    assert p.body.freq.exceptions is not None


def test_stat_binary_freq(tmp_strawboat, monkeypatch):
    monkeypatch.setenv(env.FREQ_ENV, "1")
    table = pa.table({"s": pa.array(["dom"] * 3900 + [f"x{i}" for i in range(100)])})
    info = _stat_for(
        tmp_strawboat,
        table,
        WriteOptions(default_compression=Compression.LZ4, max_page_size=4096),
    )
    p = info.pages[0]
    assert p.body.kind == "freq"
    assert p.body.freq.exceptions is None  # binary freq has plain exceptions
