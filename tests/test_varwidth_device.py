"""Mixed-width / delta-coded bitpacked pages decode on device (widths ride
as data through bitunpack_varwidth_device — no host structured fallback)."""

import os

import numpy as np
import pyarrow as pa
import pytest

from strawboat.api import read_table, write_file
from strawboat.codecs import WriteOptions
from strawboat.constants import Compression
from strawboat.exec import scan_file


def _write(path, table, **kw):
    write_file(
        path,
        table,
        options=WriteOptions(
            default_compression=Compression.LZ4,
            max_page_size=2048,
            sample_seed=0,
            **kw,
        ),
    )


def _scan_no_host_structured(path, monkeypatch):
    from strawboat.exec import scan as scan_mod

    def boom(buf, pos, length, dtype):
        raise AssertionError("page fell back to host structured decode")

    monkeypatch.setattr(scan_mod, "_decode_structured_host", boom)
    return scan_file(path)


def test_mixed_width_bitpack_device(tmp_path, monkeypatch):
    """Per-block widths vary within a page → varwidth device decode."""
    rng = np.random.default_rng(0)
    n = 8192
    # block b gets values up to 2^(4 + b%9): widths vary block to block
    vals = np.concatenate(
        [
            rng.integers(0, 1 << (4 + (b % 9)), 128).astype(np.uint32)
            for b in range(n // 128)
        ]
    )
    table = pa.table({"a": pa.array(vals, pa.uint32())})
    path = str(tmp_path / "mw.str")
    os.environ["STRAWBOAT_BITPACK_COMPRESSION"] = "1"
    try:
        _write(path, table)
    finally:
        del os.environ["STRAWBOAT_BITPACK_COMPRESSION"]
    dt = _scan_no_host_structured(path, monkeypatch)
    got = np.asarray(dt["a"].values)
    assert np.array_equal(got, vals)


def test_delta_bitpack_device(tmp_path, monkeypatch):
    """Sorted u32 column → delta-bitpack pages, cumsum restart per page."""
    rng = np.random.default_rng(1)
    n = 8192
    vals = np.sort(rng.integers(0, 1 << 20, n)).astype(np.uint32)
    table = pa.table({"a": pa.array(vals, pa.uint32())})
    path = str(tmp_path / "d.str")
    _write(path, table, default_compress_ratio=1.0)
    dt = _scan_no_host_structured(path, monkeypatch)
    got = np.asarray(dt["a"].values)
    assert np.array_equal(got, vals)
    # confirm the file really used delta pages
    from strawboat.codecs import read_header
    from strawboat.read.reader import infer_schema, read_meta

    with open(path, "rb") as f:
        infer_schema(f)
        metas = read_meta(f)
    fb = np.memmap(path, dtype=np.uint8, mode="r")
    from strawboat.read.levels import read_validity

    buf = fb[metas[0].offset : metas[0].offset + metas[0].pages[0].length]
    _v, p = read_validity(buf, 0, metas[0].pages[0].num_values)
    codec, *_ = read_header(buf, p)
    assert codec == Compression.DELTA_BITPACKING


def test_dict_with_varying_index_widths_device(tmp_path, monkeypatch):
    """Dict page whose bitpacked index subpage mixes widths per block
    (shipdate-shaped: clustered ascending values per page)."""
    rng = np.random.default_rng(2)
    n = 8192
    base = np.sort(rng.integers(0, 2000, n)).astype(np.int64)
    table = pa.table({"a": pa.array(base)})
    path = str(tmp_path / "dv.str")
    os.environ["STRAWBOAT_DICT_COMPRESSION"] = "1"
    try:
        # ratio competition on → the index subpage picks (delta-)bitpack
        _write(path, table, default_compress_ratio=1.0)
    finally:
        del os.environ["STRAWBOAT_DICT_COMPRESSION"]
    dt = _scan_no_host_structured(path, monkeypatch)
    got = np.asarray(dt["a"].values)
    assert np.array_equal(got, base)


def test_tpch_shaped_scan_matches_host_reader(tmp_path):
    """End-to-end: the lineitem column mix (dict/delta/bp/lz4) scans to the
    same rows as the host batch reader."""
    from strawboat.benchsuite.tpch import generate_lineitem

    table = generate_lineitem(scale=1.0, rows=30_000)
    path = str(tmp_path / "li.str")
    write_file(
        path,
        table,
        options=WriteOptions(
            default_compression=Compression.LZ4,
            default_compress_ratio=1.0,
            max_page_size=4096,
            sample_seed=3,
        ),
    )
    dt = scan_file(path)
    got = dt.to_arrow()
    want = read_table(path)
    for name in want.column_names:
        assert got.column(name).to_pylist() == want.column(name).to_pylist(), name
