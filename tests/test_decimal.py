"""Decimal128/Decimal256 (i128/i256) roundtrip tests across codecs."""

import decimal

import numpy as np
import pyarrow as pa
import pytest

from strawboat.api import iter_batches, read_table, write_file
from strawboat.codecs import WriteOptions
from strawboat.constants import Compression
from strawboat.util import env


@pytest.fixture(autouse=True)
def _clean_env():
    env.remove_all_env()
    yield
    env.remove_all_env()


def _roundtrip(table, path, **opt_kw):
    opts = WriteOptions(
        default_compression=Compression.LZ4,
        default_compress_ratio=1.0,
        max_page_size=1024,
        **opt_kw,
    )
    write_file(path, table, options=opts)
    got = read_table(path)
    assert got.to_pylist() == table.to_pylist()
    got2 = pa.Table.from_batches(list(iter_batches(path)))
    assert got2.to_pylist() == table.to_pylist()


def _dec(v, scale=2):
    return decimal.Decimal(v).scaleb(-scale)


def test_decimal128_mixed(tmp_strawboat):
    rng = np.random.default_rng(5)
    n = 3000
    vals = [
        _dec(int(v)) if m else None
        for v, m in zip(
            rng.integers(-(10**12), 10**12, n), rng.random(n) > 0.2
        )
    ]
    table = pa.table({"d": pa.array(vals, type=pa.decimal128(30, 2))})
    _roundtrip(table, tmp_strawboat)


def test_decimal128_low_cardinality_dict(tmp_strawboat):
    n = 4000
    vals = [_dec((i % 5) * 12345) for i in range(n)]
    table = pa.table({"d": pa.array(vals, type=pa.decimal128(20, 2))})
    _roundtrip(table, tmp_strawboat)


def test_decimal128_onevalue_and_freq(tmp_strawboat):
    n = 4000
    vals = [_dec(777)] * n
    table = pa.table({"c": pa.array(vals, type=pa.decimal128(10, 2))})
    _roundtrip(table, tmp_strawboat)
    vals2 = [_dec(10**10)] * n
    for i in range(0, n, 100):
        vals2[i] = _dec(i)
    table2 = pa.table({"f": pa.array(vals2, type=pa.decimal128(20, 2))})
    _roundtrip(table2, tmp_strawboat)


def test_decimal256(tmp_strawboat):
    rng = np.random.default_rng(6)
    n = 2000
    vals = [
        decimal.Decimal(int(v)) * (10**20) if m else None
        for v, m in zip(rng.integers(0, 10**9, n), rng.random(n) > 0.3)
    ]
    table = pa.table({"d": pa.array(vals, type=pa.decimal256(60, 0))})
    _roundtrip(table, tmp_strawboat)


def test_decimal_forced_codecs(tmp_strawboat, monkeypatch):
    n = 3000
    vals = [_dec((i % 7) * 1000) if i % 9 else None for i in range(n)]
    table = pa.table({"d": pa.array(vals, type=pa.decimal128(25, 2))})
    for var in (env.DICT_ENV, env.RLE_ENV, env.FREQ_ENV):
        monkeypatch.setenv(var, "1")
        _roundtrip(table, tmp_strawboat)
        monkeypatch.delenv(var)
