"""Zone-map pruning tests: pages outside the predicate range are skipped,
results stay exact (the page-skip behavior of reference reader.rs:91-116
driven by stats instead of an external catalog)."""

import numpy as np
import pyarrow as pa

from strawboat.api import write_file
from strawboat.codecs import WriteOptions
from strawboat.constants import Compression
from strawboat.exec import scan_file
from strawboat.exec.pruning import Comparison, read_zones


def _write_sorted(tmp_path):
    n = 8192
    path = str(tmp_path / "z.str")
    table = pa.table(
        {
            "k": pa.array(np.arange(n, dtype=np.int64)),
            "v": pa.array(np.arange(n, dtype=np.int64) * 3),
        }
    )
    write_file(
        path,
        table,
        options=WriteOptions(
            default_compression=Compression.LZ4,
            max_page_size=1024,
            zone_maps=True,
        ),
    )
    return path, table


def test_zones_written(tmp_path):
    path, _ = _write_sorted(tmp_path)
    zones = read_zones(path)
    assert zones is not None and "k" in zones
    assert len(zones["k"].pages) == 8
    assert zones["k"].pages[0].min == 0
    assert zones["k"].pages[0].max == 1023
    assert zones["k"].pages[-1].max == 8191


def test_pruned_scan_exact(tmp_path):
    path, table = _write_sorted(tmp_path)
    # predicate selects only rows in pages 6..7
    preds = [Comparison("k", "gt", 6000)]
    dt = scan_file(path, predicates=preds)
    k = np.asarray(dt["k"].values)
    v = np.asarray(dt["v"].values)
    # pages 5..7 survive (page 5 spans 5120..6143 and contains rows > 6000)
    assert len(k) == 3072
    sel = k > 6000
    assert sel.sum() == 8191 - 6000
    np.testing.assert_array_equal(v[sel], k[sel] * 3)


def test_prune_none_matches(tmp_path):
    path, _ = _write_sorted(tmp_path)
    dt = scan_file(path, predicates=[Comparison("k", "gt", 10**9)])
    assert len(dt["k"]) == 0


def test_prune_eq(tmp_path):
    path, _ = _write_sorted(tmp_path)
    dt = scan_file(path, predicates=[Comparison("k", "eq", 5000)])
    assert len(dt["k"]) == 1024  # single page
    assert 5000 in np.asarray(dt["k"].values)


def test_zones_are_in_band(tmp_path):
    """No sidecar file: zones live between page data and the schema, and the
    footer stays byte-identical in layout (readable by footer-only parsers)."""
    import os

    import numpy as np
    import pyarrow as pa

    from strawboat.api import read_table, write_file
    from strawboat.codecs import WriteOptions
    from strawboat.constants import Compression

    table = pa.table({"k": pa.array(np.arange(4096, dtype=np.int64))})
    path = str(tmp_path / "inband.str")
    write_file(
        path,
        table,
        options=WriteOptions(
            default_compression=Compression.LZ4, max_page_size=1024, zone_maps=True
        ),
    )
    assert not os.path.exists(path + ".zm.json")
    zones = read_zones(path)
    assert zones is not None and len(zones["k"].pages) == 4
    # a zone-unaware footer reader parses the file unchanged
    got = read_table(path)
    assert got.column("k").to_pylist() == list(range(4096))


def test_zone_serializer_preserves_width():
    """i64 beyond 2^53, u64 beyond i64, floats and all-null pages all
    roundtrip exactly (no lossy f64-of-int)."""
    from strawboat.exec.pruning import (
        ColumnZones,
        PageZone,
        deserialize_zones,
        serialize_zones,
    )

    big = (1 << 62) + 12345
    ubig = (1 << 63) + 7
    zones = {
        "i": ColumnZones("i", [PageZone(-big, big, 0, 10), PageZone(None, None, 10, 10)]),
        "u": ColumnZones("u", [PageZone(0, ubig, 1, 8)]),
        "f": ColumnZones("f", [PageZone(-0.5, 2.25, 2, 4)]),
    }
    got = deserialize_zones(serialize_zones(zones))
    assert got["i"].pages[0].min == -big and got["i"].pages[0].max == big
    assert got["i"].pages[1].min is None
    assert got["u"].pages[0].max == ubig
    assert got["f"].pages[0].min == -0.5 and got["f"].pages[0].max == 2.25


def test_string_columns_emit_no_byte_zones(tmp_path):
    """Binary/utf8 leaves must not publish byte-buffer min/max as row zones.

    The leaf's values buffer is raw u8 BYTES (offsets-addressed), so a
    numeric zone computed over it is garbage — and with nulls the compacted
    buffer is shorter than the validity, which used to crash the writer.
    """
    import pyarrow as pa

    from strawboat.api import write_file
    from strawboat.codecs import WriteOptions
    from strawboat.constants import Compression
    from strawboat.exec.pruning import read_zones

    t = pa.table(
        {
            "a": pa.array([1, 2, 3], type=pa.int64()),
            "s": pa.array(["x", None, "z"]),
            "s2": pa.array(["p", "q", "r"]),  # no nulls: used to get byte zones
        }
    )
    path = str(tmp_path / "z.str")
    write_file(
        path,
        t,
        options=WriteOptions(
            default_compression=Compression.LZ4,
            default_compress_ratio=None,
            max_page_size=2,
            zone_maps=True,
        ),
    )
    zones = read_zones(path)
    assert zones is not None and "a" in zones
    assert "s" not in zones and "s2" not in zones
