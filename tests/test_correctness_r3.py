"""Round-3 correctness tests: the silent-wrong-answer classes from VERDICT r2.

1. Composite-key aggregates must be exact — a crafted pair of key tuples that
   collide under the old polynomial u64 mix must still form two groups.
2. Pruning atoms must compare exactly — int literals near/above 2^53 and at
   2^63-1, and float literals against integer zones, must never prune a
   matching page.
3. Join null handling must be sentinel-free — a legitimate build key equal to
   the old ``-(2**62)`` sentinel must join; a null build row whose decoded
   storage happens to equal a probe key must not.
4. ``scan_chunks`` must never silently drop nested columns.
"""

import numpy as np
import pyarrow as pa

import jax.numpy as jnp

from strawboat.api import write_file
from strawboat.codecs import WriteOptions
from strawboat.constants import Compression
from strawboat.exec import scan_file
from strawboat.exec.aggregate import hash_aggregate
from strawboat.exec.expr import col
from strawboat.exec.pruning import Comparison, read_zones
from strawboat.exec.scan import DeviceColumn, DeviceTable, scan_chunks

MIX = 0x9E3779B97F4A7C15  # the reporting-key multiplier


def _table(cols):
    dcols = {
        name: DeviceColumn(name, None, jnp.asarray(v), validity)
        for name, (v, validity) in cols.items()
    }
    n = len(next(iter(cols.values()))[0])
    return DeviceTable(dcols, n)


def test_composite_key_collision_groups_stay_distinct():
    # (0, wrap(MIX+5)) and (1, 5) satisfy a*MIX + b == const — the exact
    # collision class of the old mixed-u64 grouping
    b1 = np.int64((MIX + 5) - (1 << 64))  # two's-complement image of MIX+5
    a = np.array([0, 1, 0, 1], dtype=np.int64)
    b = np.array([b1, 5, b1, 5], dtype=np.int64)
    v = np.array([10, 100, 1, 2], dtype=np.int64)
    t = _table({"a": (a, None), "b": (b, None), "v": (v, None)})
    res = hash_aggregate(t, ["a", "b"], {"s": ("sum", "v")}, num_groups=8)
    n = int(res["n_groups"])
    assert n == 2, f"collision merged groups: {n}"
    got = {}
    for i in range(n):
        got[(int(res["key_a"][i]), int(res["key_b"][i]))] = int(res["s"][i])
    assert got == {(0, int(b1)): 11, (1, 5): 102}


def test_composite_key_float_column_exact():
    # floats group by bit pattern, not by int truncation (2.0 vs 2.5)
    a = np.array([1, 1, 1, 1], dtype=np.int64)
    f = np.array([2.0, 2.5, 2.0, 2.5], dtype=np.float32)
    v = np.array([1, 10, 2, 20], dtype=np.int64)
    t = _table({"a": (a, None), "f": (f, None), "v": (v, None)})
    res = hash_aggregate(t, ["a", "f"], {"s": ("sum", "v")}, num_groups=8)
    assert int(res["n_groups"]) == 2
    sums = sorted(int(res["s"][i]) for i in range(2))
    assert sums == [3, 30]


def _write_pages(tmp_path, values, name="k"):
    path = str(tmp_path / "exact.str")
    table = pa.table({name: pa.array(values, pa.int64())})
    write_file(
        path,
        table,
        options=WriteOptions(
            default_compression=Compression.LZ4,
            max_page_size=2,
            zone_maps=True,
        ),
    )
    return path


def test_pruning_exact_above_2_53(tmp_path):
    lo, hi = (1 << 53), (1 << 53) + 1  # adjacent ints that collapse in f64
    path = _write_pages(tmp_path, [0, 1, lo, hi, 99, 100])
    zones = read_zones(path)
    assert zones["k"].kind == "i"
    # DSL atom keeps the int literal exact
    e = col("k") == hi
    atom = e.atoms[0]
    assert isinstance(atom.value, int) and atom.value == hi
    dt = scan_file(path, predicates=[atom])
    k = np.asarray(dt["k"].values)
    assert hi in k.tolist(), "eq atom pruned the matching page"
    dt2 = scan_file(path, predicates=[Comparison("k", "ge", hi)])
    assert hi in np.asarray(dt2["k"].values).tolist()
    # and the sibling value must NOT satisfy eq after the scan filter
    assert (k == hi).sum() == 1


def test_pruning_exact_at_int64_max(tmp_path):
    m = (1 << 63) - 1
    path = _write_pages(tmp_path, [0, 1, m - 1, m, 7, 8])
    dt = scan_file(path, predicates=[Comparison("k", "eq", m)])
    assert m in np.asarray(dt["k"].values).tolist()
    dt2 = scan_file(path, predicates=[Comparison("k", "gt", m - 1)])
    assert m in np.asarray(dt2["k"].values).tolist()


def test_pruning_float_literal_against_int_zone(tmp_path):
    path = _write_pages(tmp_path, [0, 1, 2, 3, 4, 5])
    # col > 2.5 must keep the page holding 3 (pages of 2 rows: [2,3])
    dt = scan_file(path, predicates=[Comparison("k", "gt", 2.5)])
    vals = np.asarray(dt["k"].values).tolist()
    assert 3 in vals and 5 in vals
    # col <= 0.5 keeps only the first page
    dt2 = scan_file(path, predicates=[Comparison("k", "le", 0.5)])
    assert 0 in np.asarray(dt2["k"].values).tolist()
    # eq on a non-integral float can never match an int column
    dt3 = scan_file(path, predicates=[Comparison("k", "eq", 2.5)])
    assert len(dt3["k"]) == 0
    # NaN comparisons match nothing
    dt4 = scan_file(path, predicates=[Comparison("k", "gt", float("nan"))])
    assert len(dt4["k"]) == 0


def test_join_key_equal_to_old_sentinel_matches():
    from strawboat.exec.join import hash_join

    sentinel = -(2**62)
    probe = _table({"k": (np.array([sentinel, 5], dtype=np.int64), None)})
    build = _table(
        {
            "k": (
                np.array([sentinel, 7], dtype=np.int64),
                jnp.asarray([True, True]),
            )
        }
    )
    pi, bi, valid = hash_join(probe, build, on=("k", "k"))
    v = np.asarray(valid)
    assert v.sum() == 1  # the sentinel-valued key joins like any other
    assert int(np.asarray(pi)[v][0]) == 0 and int(np.asarray(bi)[v][0]) == 0


def test_join_null_build_key_never_matches_stored_value():
    from strawboat.exec.join import hash_join

    # null build row whose *stored* key equals a probe key: must not match
    probe = _table({"k": (np.array([42], dtype=np.int64), None)})
    build = _table(
        {
            "k": (
                np.array([42, 42], dtype=np.int64),
                jnp.asarray([False, True]),  # first row is NULL
            )
        }
    )
    pi, bi, valid = hash_join(probe, build, on=("k", "k"), max_fanout=2)
    v = np.asarray(valid)
    assert v.sum() == 1
    assert int(np.asarray(bi)[v][0]) == 1  # only the valid build row


def test_scan_chunks_carries_nested_columns(tmp_path):
    n = 64
    path = str(tmp_path / "nested.str")
    lists = [list(range(i % 4)) for i in range(n)]
    table = pa.table(
        {
            "x": pa.array(np.arange(n, dtype=np.int64)),
            "l": pa.array(lists, pa.list_(pa.int64())),
        }
    )
    write_file(
        path,
        table,
        options=WriteOptions(
            default_compression=Compression.LZ4, max_page_size=16
        ),
    )
    got_rows = 0
    got_leaf = []
    for chunk in scan_chunks(path, chunk_pages=2):
        assert "l" in chunk.columns, "chunked scan dropped the list column"
        assert "x" in chunk.columns
        got_rows += len(chunk["x"])
        got_leaf.append(np.asarray(chunk["l"].values))
    assert got_rows == n
    flat = np.concatenate(got_leaf)
    expect = np.concatenate([np.asarray(l, dtype=np.int64) for l in lists if l])
    np.testing.assert_array_equal(flat, expect)


def test_scan_file_pruned_nested_stays_row_aligned(tmp_path):
    # pruning drops pages for EVERY column, including nested ones
    n = 64
    path = str(tmp_path / "nested_pruned.str")
    lists = [[i, i] for i in range(n)]
    table = pa.table(
        {
            "k": pa.array(np.arange(n, dtype=np.int64)),
            "l": pa.array(lists, pa.list_(pa.int64())),
        }
    )
    write_file(
        path,
        table,
        options=WriteOptions(
            default_compression=Compression.LZ4,
            max_page_size=16,
            zone_maps=True,
        ),
    )
    dt = scan_file(path, predicates=[Comparison("k", "ge", 32)])
    k = np.asarray(dt["k"].values)
    assert len(k) == 32  # two pages survive
    lcol = dt["l"]
    # each surviving row has its 2-element list, aligned with k
    offs = np.asarray(lcol.offsets)
    assert len(offs) - 1 == len(k)
    vals = np.asarray(lcol.values)
    np.testing.assert_array_equal(vals.reshape(-1, 2)[:, 0], k)
