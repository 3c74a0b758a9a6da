"""Device string scan: dict-codec pages must upload packed codes directly —
no per-row arrow re-encode (round-1 verdict item 4)."""

import numpy as np
import pyarrow as pa
import pytest

from strawboat.api import write_file
from strawboat.codecs import WriteOptions
from strawboat.constants import Compression
from strawboat.exec import scan_file


def _write(path, table, **kw):
    write_file(
        path,
        table,
        options=WriteOptions(
            default_compression=Compression.LZ4,
            max_page_size=kw.pop("max_page_size", 1024),
            **kw,
        ),
    )


@pytest.fixture
def dict_string_file(tmp_path):
    import os

    rng = np.random.default_rng(5)
    n = 5000
    words = [f"word-{i}" for i in range(40)]
    vals = [words[i] for i in rng.integers(0, len(words), n)]
    table = pa.table({"s": pa.array(vals, pa.string())})
    path = str(tmp_path / "dict_str.str")
    os.environ["STRAWBOAT_DICT_COMPRESSION"] = "1"
    try:
        _write(path, table)
    finally:
        del os.environ["STRAWBOAT_DICT_COMPRESSION"]
    return path, table, vals


def test_dict_string_pages_never_reencode(dict_string_file, monkeypatch):
    """All pages dict-coded → zero dictionary_encode calls during scan."""
    from strawboat.exec import scan as scan_mod

    path, table, vals = dict_string_file

    def boom(arr):
        raise AssertionError("dictionary_encode called on dict-page fast path")

    monkeypatch.setattr(scan_mod, "_dictionary_encode", boom)
    dt = scan_file(path)
    got = dt.to_arrow().column("s").to_pylist()
    assert got == vals


def test_dict_string_multi_page_dictionary_merge(dict_string_file):
    """Per-page dictionaries differ (different words per page range) and must
    merge by base-offset remap into one consistent global dictionary."""
    path, table, vals = dict_string_file
    dt = scan_file(path)
    c = dt["s"]
    assert c.dictionary is not None
    codes = np.asarray(c.values)
    d = [
        v.decode() if isinstance(v, bytes) else v
        for v in c.dictionary.to_pylist()
    ]
    # global dictionary has no duplicates
    assert len(set(d)) == len(d)
    assert [d[c_] for c_ in codes] == vals


def test_mixed_raw_and_dict_string_pages(tmp_path, monkeypatch):
    """Raw pages (high cardinality) may re-encode; rows still correct with a
    shared dictionary across raw and dict pages."""
    import os

    n = 3000
    # page 1-2: low cardinality (dict picks up under ratio competition),
    # page 3: unique strings (raw)
    vals = [f"k-{i % 12}" for i in range(2048)] + [
        f"unique-{i}" for i in range(n - 2048)
    ]
    table = pa.table({"s": pa.array(vals, pa.string())})
    path = str(tmp_path / "mixed.str")
    _write(path, table, default_compress_ratio=1.0, max_page_size=1024)
    from strawboat.exec import scan as scan_mod

    calls = []
    orig = scan_mod._dictionary_encode
    monkeypatch.setattr(
        scan_mod, "_dictionary_encode", lambda a: calls.append(len(a)) or orig(a)
    )
    dt = scan_file(path)
    got = dt.to_arrow().column("s").to_pylist()
    assert got == vals
    # per-row encode ran only over raw-page rows, never the whole column
    assert sum(calls) < len(vals)


def test_nullable_dict_string_roundtrip(tmp_path):
    import os

    rng = np.random.default_rng(9)
    n = 4000
    vals = [
        None if rng.random() < 0.2 else f"v{int(i)}"
        for i in rng.integers(0, 30, n)
    ]
    table = pa.table({"s": pa.array(vals, pa.string())})
    path = str(tmp_path / "nullable.str")
    os.environ["STRAWBOAT_DICT_COMPRESSION"] = "1"
    try:
        _write(path, table)
    finally:
        del os.environ["STRAWBOAT_DICT_COMPRESSION"]
    dt = scan_file(path)
    got = dt.to_arrow().column("s").to_pylist()
    assert got == vals
