"""Device-encoder writer: codec choice from HBM-resident page stats
(reference hot loops integer/mod.rs:179-347 as batched device reductions)."""

import numpy as np
import pyarrow as pa

from strawboat.api import read_table, write_file
from strawboat.codecs import WriteOptions
from strawboat.constants import Compression
from strawboat.exec import scan_file
from strawboat.read.reader import infer_schema, open_readers, read_meta
from strawboat.stat import stat_simple
from strawboat.write.device import write_device_table


def _page_kinds(path):
    """column name → set of page body kinds (via the stat layer)."""
    with open(path, "rb") as f:
        schema = infer_schema(f)
        metas = read_meta(f)
    out = {}
    for i, field in enumerate(schema):
        readers = open_readers(path, [metas[i]])
        info = stat_simple(readers[0], field)
        for r in readers:
            r.page_reader.close()
        out[field.name] = {p.body.kind for p in info.pages}
    return out


def _roundtrip(tmp_path, table, **opt_kw):
    """arrow → file → DeviceTable → device-encode → rescan → arrow."""
    src = str(tmp_path / "src.str")
    dst = str(tmp_path / "dst.str")
    write_file(
        src,
        table,
        options=WriteOptions(
            default_compression=Compression.LZ4, max_page_size=1024
        ),
    )
    dt = scan_file(src)
    write_device_table(
        dst,
        dt,
        WriteOptions(
            default_compression=Compression.LZ4,
            max_page_size=1024,
            **opt_kw,
        ),
    )
    return read_table(dst), dst


def test_numeric_roundtrip(tmp_path):
    rng = np.random.default_rng(0)
    n = 5000
    table = pa.table(
        {
            "i": pa.array(rng.integers(-1000, 1000, n).astype(np.int64)),
            "f": pa.array(rng.random(n)),
            "u": pa.array(rng.integers(0, 1 << 20, n).astype(np.uint32)),
        }
    )
    got, _ = _roundtrip(tmp_path, table)
    assert got.equals(table.cast(got.schema))


def test_adaptive_choices_from_device_stats(tmp_path):
    """Constant page → OneValue, sorted u32 → (delta-)bitpack, low-cardinality
    → Dict: all chosen from device reductions (ratio competition on)."""
    n = 2048
    table = pa.table(
        {
            "const": pa.array(np.full(n, 7, dtype=np.int64)),
            "sorted_u32": pa.array(
                np.arange(n, dtype=np.uint32) * 3, pa.uint32()
            ),
            "lowcard": pa.array(
                np.random.default_rng(1).integers(0, 4, n).astype(np.int64)
            ),
        }
    )
    got, dst = _roundtrip(tmp_path, table, default_compress_ratio=1.0)
    assert got.equals(table.cast(got.schema))
    kinds = _page_kinds(dst)
    assert kinds["const"] == {"one_value"}
    assert kinds["sorted_u32"] <= {"delta_bitpack", "bitpack"}
    assert kinds["lowcard"] == {"dict"}


def test_nullable_roundtrip(tmp_path):
    rng = np.random.default_rng(2)
    n = 4000
    vals = rng.integers(0, 100, n).astype(np.int64)
    mask = rng.random(n) < 0.25
    table = pa.table(
        {"x": pa.array(vals, mask=mask), "y": pa.array(rng.random(n))}
    )
    got, _ = _roundtrip(tmp_path, table)
    assert got.column("x").to_pylist() == table.column("x").to_pylist()
    assert got.column("y").to_pylist() == table.column("y").to_pylist()


def test_string_dict_direct_roundtrip(tmp_path, monkeypatch):
    """String columns re-encode as Dict pages straight from device codes —
    per-row string materialization (dictionary_encode / python row loops)
    must never run."""
    import os

    rng = np.random.default_rng(3)
    n = 4000
    words = [f"city-{i}" for i in range(23)]
    vals = [words[i] for i in rng.integers(0, len(words), n)]
    table = pa.table({"s": pa.array(vals, pa.string())})
    src = str(tmp_path / "src.str")
    dst = str(tmp_path / "dst.str")
    os.environ["STRAWBOAT_DICT_COMPRESSION"] = "1"
    try:
        write_file(
            src,
            table,
            options=WriteOptions(
                default_compression=Compression.LZ4, max_page_size=1024
            ),
        )
    finally:
        del os.environ["STRAWBOAT_DICT_COMPRESSION"]
    dt = scan_file(src)

    import strawboat.codecs.binary as binary_codec

    def boom(*a, **k):
        raise AssertionError("row-wise binary dict_encode ran on device path")

    monkeypatch.setattr(binary_codec, "dict_encode", boom)
    write_device_table(
        dst,
        dt,
        WriteOptions(default_compression=Compression.LZ4, max_page_size=1024),
    )
    got = read_table(dst)
    assert got.column("s").to_pylist() == vals
    assert _page_kinds(dst)["s"] == {"dict"}


def test_nullable_string_roundtrip(tmp_path):
    import os

    rng = np.random.default_rng(7)
    n = 3000
    vals = [
        None if rng.random() < 0.2 else f"w{int(i)}"
        for i in rng.integers(0, 30, n)
    ]
    table = pa.table({"s": pa.array(vals, pa.string())})
    src = str(tmp_path / "src.str")
    dst = str(tmp_path / "dst.str")
    os.environ["STRAWBOAT_DICT_COMPRESSION"] = "1"
    try:
        write_file(
            src,
            table,
            options=WriteOptions(
                default_compression=Compression.LZ4, max_page_size=1024
            ),
        )
    finally:
        del os.environ["STRAWBOAT_DICT_COMPRESSION"]
    dt = scan_file(src)
    write_device_table(
        dst,
        dt,
        WriteOptions(default_compression=Compression.LZ4, max_page_size=1024),
    )
    got = read_table(dst)
    assert got.column("s").to_pylist() == vals


def test_shuffle_then_device_encode(tmp_path):
    """The SURVEY §7 step-3 story: scan → device transform → re-encode →
    rescan equality, with the sorted key column compressing structurally."""
    import jax.numpy as jnp

    from strawboat.exec.scan import DeviceColumn, DeviceTable

    rng = np.random.default_rng(4)
    n = 6000
    table = pa.table(
        {
            "k": pa.array(rng.integers(0, 64, n).astype(np.int64)),
            "v": pa.array(rng.integers(0, 1 << 30, n).astype(np.int64)),
        }
    )
    src = str(tmp_path / "src.str")
    dst = str(tmp_path / "dst.str")
    write_file(
        src,
        table,
        options=WriteOptions(
            default_compression=Compression.LZ4, max_page_size=2048
        ),
    )
    dt = scan_file(src)
    # device shuffle: sort by key (a deterministic stand-in for the
    # all_to_all exchange — rows re-ordered on device, then re-encoded)
    order = jnp.argsort(dt["k"].values)
    shuffled = DeviceTable(
        {
            name: DeviceColumn(name, c.dtype, c.values[order], None)
            for name, c in dt.columns.items()
        },
        dt.num_rows,
    )
    write_device_table(
        dst,
        shuffled,
        WriteOptions(
            default_compression=Compression.LZ4,
            max_page_size=2048,
            default_compress_ratio=1.0,
        ),
    )
    got = read_table(dst)
    got_k = np.asarray(got.column("k"))
    assert (np.diff(got_k) >= 0).all()  # shuffle order preserved
    assert sorted(
        zip(got_k.tolist(), np.asarray(got.column("v")).tolist())
    ) == sorted(
        zip(
            np.asarray(table.column("k")).tolist(),
            np.asarray(table.column("v")).tolist(),
        )
    )
    kinds = _page_kinds(dst)
    assert kinds["k"] & {"rle", "dict", "delta_bitpack", "bitpack", "one_value"}


def test_empty_table(tmp_path):
    table = pa.table({"a": pa.array([], pa.int64())})
    got, _ = _roundtrip(tmp_path, table)
    assert got.num_rows == 0


def test_decimal_roundtrip(tmp_path):
    """decimal128(≤18) rides as unscaled int64 on device; re-encode emits
    the i128 byte-matrix family back."""
    from decimal import Decimal

    vals = [Decimal("1.23"), Decimal("-45.10"), None, Decimal("999.99")] * 300
    table = pa.table({"d": pa.array(vals, pa.decimal128(12, 2))})
    got, _ = _roundtrip(tmp_path, table)
    assert got.column("d").to_pylist() == vals


def test_device_write_emits_zone_maps(tmp_path):
    """scan → device-rewrite → pruned scan actually skips pages
    (VERDICT r2 missing #2: rewritten files must keep their pruning)."""
    from strawboat.exec.pruning import Comparison, read_zones

    n = 8192
    src = str(tmp_path / "zsrc.str")
    dst = str(tmp_path / "zdst.str")
    table = pa.table(
        {
            "k": pa.array(np.arange(n, dtype=np.int64)),
            "f": pa.array(np.arange(n, dtype=np.float64) / 8),
        }
    )
    write_file(
        src,
        table,
        options=WriteOptions(
            default_compression=Compression.LZ4, max_page_size=1024, zone_maps=True
        ),
    )
    dt = scan_file(src)
    write_device_table(
        dst,
        dt,
        WriteOptions(
            default_compression=Compression.LZ4, max_page_size=1024, zone_maps=True
        ),
    )
    zones = read_zones(dst)
    assert zones is not None and "k" in zones and "f" in zones
    assert len(zones["k"].pages) == 8
    assert zones["k"].pages[0].min == 0 and zones["k"].pages[0].max == 1023
    assert zones["f"].pages[-1].max == (n - 1) / 8
    # pruned scan of the REWRITTEN file decodes only surviving pages
    pruned = scan_file(dst, predicates=[Comparison("k", "ge", 7168)])
    k = np.asarray(pruned["k"].values)
    assert len(k) == 1024  # one page survives
    np.testing.assert_array_equal(k, np.arange(7168, 8192))


def test_device_write_zone_maps_nullable_and_bool(tmp_path):
    from strawboat.exec.pruning import Comparison, read_zones

    n = 4096
    rng = np.random.default_rng(5)
    src = str(tmp_path / "nbsrc.str")
    dst = str(tmp_path / "nbdst.str")
    vals = np.arange(n, dtype=np.int64)
    mask = rng.random(n) < 0.25
    table = pa.table(
        {
            "nv": pa.array(vals, mask=mask),
            "b": pa.array((vals >= n // 2)),
        }
    )
    write_file(
        src,
        table,
        options=WriteOptions(
            default_compression=Compression.LZ4, max_page_size=512, zone_maps=True
        ),
    )
    dt = scan_file(src)
    write_device_table(
        dst,
        dt,
        WriteOptions(
            default_compression=Compression.LZ4, max_page_size=512, zone_maps=True
        ),
    )
    zones = read_zones(dst)
    assert zones is not None and "nv" in zones and "b" in zones
    # null counts recorded per page
    assert sum(p.null_count for p in zones["nv"].pages) == int(mask.sum())
    # boolean zones prune an all-false page range
    pruned = scan_file(dst, predicates=[Comparison("b", "eq", True)])
    assert len(pruned["b"]) == n // 2


def test_decimal_zones_never_misprune(tmp_path):
    """Decimal byte-matrix pages must not emit byte-level zone garbage: a
    value of 300 has byte max 44 — a naive zone would wrongly prune
    ``dec > 100``.  Host files emit no decimal zones; device-rewritten files
    emit zones over the unscaled int64 (the scan's value domain)."""
    from strawboat.exec.pruning import Comparison, read_zones

    n = 2048
    src = str(tmp_path / "dsrc.str")
    dst = str(tmp_path / "ddst.str")
    vals = [300 + i for i in range(n)]  # unscaled; bytes stay small
    table = pa.table({"dec": pa.array(vals, pa.decimal128(10, 2))})
    write_file(
        src,
        table,
        options=WriteOptions(
            default_compression=Compression.LZ4, max_page_size=256, zone_maps=True
        ),
    )
    zones = read_zones(src)
    assert zones is None or "dec" not in zones  # no byte-garbage zones
    dt = scan_file(src, predicates=[Comparison("dec", "gt", 100)])
    assert len(dt["dec"]) == n  # nothing mis-pruned
    write_device_table(
        dst,
        scan_file(src),
        WriteOptions(
            default_compression=Compression.LZ4, max_page_size=256, zone_maps=True
        ),
    )
    zones2 = read_zones(dst)
    assert zones2 is not None and "dec" in zones2
    assert zones2["dec"].pages[0].min == 30000  # unscaled (×10^2) domain
    pruned = scan_file(
        dst, predicates=[Comparison("dec", "ge", (300 + n - 256) * 100)]
    )
    assert len(pruned["dec"]) == 256  # last page only


def test_device_bool_packed_path_roundtrip(tmp_path):
    """Boolean columns go through the device packed-bit path (pack on
    device, slice bytes on host): raw, RLE, and OneValue page shapes all
    roundtrip; nullable validity preserved (VERDICT r2 weak #9)."""
    rng = np.random.default_rng(8)
    n = 4096
    mixed = rng.integers(0, 2, n).astype(bool)  # raw pages
    runs = np.repeat(rng.integers(0, 2, 16).astype(bool), n // 16)  # RLE
    ones = np.ones(n, dtype=bool)  # OneValue
    mask = rng.random(n) < 0.2
    table = pa.table(
        {
            "mixed": pa.array(mixed),
            "runs": pa.array(runs),
            "ones": pa.array(ones),
            "nb": pa.array(mixed, mask=mask),
        }
    )
    got, dst = _roundtrip(tmp_path, table, default_compress_ratio=1.0)
    assert got.to_pydict() == table.to_pydict()  # schema nullability may tighten
    kinds = _page_kinds(dst)
    assert "one_value" in kinds["ones"]
    assert "rle" in kinds["runs"]


def test_device_writer_freq_exact_fallback(tmp_path):
    """A top-heavy low-cardinality page re-enables FREQ via the exact host
    mode (the estimate-only gap documented in round 2)."""
    n = 4096
    vals = np.full(n, 7_777, dtype=np.int64)
    # ~5% exceptions -> top value 95% dominant, 2 distinct
    vals[:: 20] = 1_234_567
    table = pa.table({"topheavy": pa.array(vals)})
    got, dst = _roundtrip(tmp_path, table, default_compress_ratio=1.0)
    assert got.to_pydict() == table.to_pydict()
    kinds = _page_kinds(dst)
    assert "freq" in kinds["topheavy"], kinds


def test_list_int_device_write_roundtrip(tmp_path):
    """scan → device-write → rescan for list<int64> (VERDICT r3 missing #4):
    nested preludes emitted from the device-fetched offsets."""
    rng = np.random.default_rng(3)
    n = 600
    lens = rng.integers(0, 6, n)
    vals = [rng.integers(0, 1000, k).tolist() for k in lens]
    table = pa.table(
        {"l": pa.array(vals, pa.list_(pa.int64()))},
        schema=pa.schema([pa.field("l", pa.list_(pa.int64()), nullable=False)]),
    )
    got, _dst = _roundtrip(tmp_path, table)
    assert got.column("l").to_pylist() == vals


def test_list_utf8_device_write_roundtrip(tmp_path):
    rng = np.random.default_rng(4)
    n = 400
    words = np.array(["alpha", "beta", "gamma", "delta", ""])
    vals = [
        words[rng.integers(0, len(words), k)].tolist()
        for k in rng.integers(0, 5, n)
    ]
    table = pa.table(
        {"s": pa.array(vals, pa.list_(pa.string()))},
        schema=pa.schema(
            [pa.field("s", pa.list_(pa.string()), nullable=False)]
        ),
    )
    got, _dst = _roundtrip(tmp_path, table)
    assert got.column("s").to_pylist() == vals


def test_list_nullable_device_write_roundtrip(tmp_path):
    """Nullable list rows survive the device re-encode."""
    vals = [[1, 2], None, [], [3], None, [4, 5, 6]] * 50
    table = pa.table({"ln": pa.array(vals, pa.list_(pa.int64()))})
    got, _dst = _roundtrip(tmp_path, table)
    assert got.column("ln").to_pylist() == vals
