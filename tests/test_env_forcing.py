"""Codec-forcing env-var tests — the reference CI's forced-codec matrix
(.github/workflows/rust.yml:19-25 reruns the suite with FREQ/DICT/RLE forced;
debug-only branches in every choose_compressor, util/env.rs:20-83)."""

import numpy as np
import pyarrow as pa
import pytest

from conftest import (
    create_random_bool,
    create_random_double,
    create_random_index,
    create_random_string,
)
from strawboat.api import read_table, write_file
from strawboat.codecs import WriteOptions
from strawboat.constants import Compression
from strawboat.util import env


@pytest.fixture(autouse=True)
def _clean_env():
    env.remove_all_env()
    yield
    env.remove_all_env()


def _table(size=3000):
    return pa.table(
        {
            "i32": create_random_index(size, 0.2, 16),
            "f64": create_random_double(size, 0.1),
            "bool": create_random_bool(size, 0.2),
            "utf8": create_random_string(size, 0.1, 10),
            "list": pa.array(
                [[i, None, i + 1] if i % 5 else None for i in range(size)],
                type=pa.list_(pa.int64()),
            ),
        }
    )


@pytest.mark.parametrize(
    "var", [env.DICT_ENV, env.RLE_ENV, env.FREQ_ENV, env.BITPACK_ENV, env.PATAS_ENV]
)
def test_forced_roundtrip(tmp_strawboat, var, monkeypatch):
    monkeypatch.setenv(var, "1")
    table = _table()
    write_file(
        tmp_strawboat,
        table,
        options=WriteOptions(default_compression=Compression.LZ4, max_page_size=1024),
    )
    got = read_table(tmp_strawboat)
    assert got.to_pylist() == table.to_pylist()


def test_forced_codec_actually_used(tmp_strawboat, monkeypatch):
    monkeypatch.setenv(env.DICT_ENV, "1")
    from strawboat.codecs.integer import compress_integer

    buf = compress_integer(
        np.arange(100, dtype=np.int64), None, WriteOptions()
    )
    assert buf[0] == Compression.DICT
