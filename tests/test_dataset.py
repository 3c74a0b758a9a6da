"""Multi-file dataset scan: footer-only file pruning + device concat.

The reference is single-file (src/read/reader.rs); this layer is the
production multi-file consumption pattern on top, so tests check the two
things the single-file suite cannot: whole-file zone skips and cross-file
column concatenation (incl. dictionary merge).
"""

import numpy as np
import pyarrow as pa
import pytest

from strawboat.api import write_file
from strawboat.codecs import WriteOptions
from strawboat.constants import Compression
from strawboat.exec import scan_dataset
from strawboat.exec.dataset import (
    file_may_match,
    iter_dataset_chunks,
    resolve_paths,
)
from strawboat.exec.pruning import Comparison

OPTS = WriteOptions(
    default_compression=Compression.LZ4,
    default_compress_ratio=None,
    max_page_size=256,
    zone_maps=True,
)


def _write_parts(tmp_path, n_files=3, rows=700, with_strings=True):
    paths = []
    tables = []
    for i in range(n_files):
        rng = np.random.default_rng(i)
        base = i * 10_000
        a = np.sort(rng.integers(base, base + 5000, rows)).astype(np.int64)
        cols = {"a": pa.array(a)}
        if with_strings:
            # per-file distinct vocab overlap: forces a real dictionary merge
            vocab = [f"s{i}", f"s{i+1}", "common"]
            cols["s"] = pa.array([vocab[j % 3] for j in range(rows)])
        t = pa.table(cols)
        p = str(tmp_path / f"part-{i}.str")
        write_file(p, t, options=OPTS)
        paths.append(p)
        tables.append(t)
    return paths, tables


def test_scan_dataset_concat_matches_arrow(tmp_path):
    paths, tables = _write_parts(tmp_path)
    dt = scan_dataset(paths)
    got = dt.to_arrow()
    exp = pa.concat_tables(tables)
    assert got.column("a").to_pylist() == exp.column("a").to_pylist()
    assert got.column("s").to_pylist() == exp.column("s").to_pylist()
    assert dt.num_rows == exp.num_rows


def test_scan_dataset_glob(tmp_path):
    paths, tables = _write_parts(tmp_path, with_strings=False)
    dt = scan_dataset(str(tmp_path / "part-*.str"))
    assert dt.num_rows == sum(t.num_rows for t in tables)
    assert resolve_paths(str(tmp_path / "part-*.str")) == paths


def test_file_level_pruning_skips_whole_files(tmp_path):
    paths, tables = _write_parts(tmp_path, with_strings=False)
    # predicate only file 1 (values 10000..15000) can satisfy
    preds = [Comparison("a", "ge", 10_000), Comparison("a", "lt", 15_000)]
    assert not file_may_match(paths[0], preds)
    assert file_may_match(paths[1], preds)
    assert not file_may_match(paths[2], preds)
    dt = scan_dataset(paths, predicates=preds)
    vals = np.asarray(dt["a"].values)
    exp = tables[1].column("a").to_numpy()
    np.testing.assert_array_equal(vals, exp)


def test_dataset_prunes_to_empty_keeps_schema(tmp_path):
    paths, _ = _write_parts(tmp_path, with_strings=False)
    preds = [Comparison("a", "ge", 10**9)]
    dt = scan_dataset(paths, predicates=preds)
    assert dt.num_rows == 0
    assert "a" in dt.columns and len(dt["a"]) == 0


def test_dataset_nullable_and_dict_merge(tmp_path):
    # explicit nulls in one file only; dictionary union must stay exact
    t1 = pa.table(
        {
            "a": pa.array([1, None, 3], type=pa.int64()),
            "s": pa.array(["x", "y", "x"]),
        }
    )
    t2 = pa.table(
        {
            "a": pa.array([4, 5, 6], type=pa.int64()),
            "s": pa.array(["y", "z", None]),
        }
    )
    p1, p2 = str(tmp_path / "n1.str"), str(tmp_path / "n2.str")
    write_file(p1, t1, options=OPTS)
    write_file(p2, t2, options=OPTS)
    got = scan_dataset([p1, p2]).to_arrow()
    exp = pa.concat_tables([t1, t2])
    assert got.column("a").to_pylist() == exp.column("a").to_pylist()
    assert got.column("s").to_pylist() == exp.column("s").to_pylist()


def test_dataset_schema_mismatch_raises(tmp_path):
    from strawboat.errors import OutOfSpecError

    t1 = pa.table({"a": pa.array([1, 2], type=pa.int64())})
    t2 = pa.table({"b": pa.array([3, 4], type=pa.int64())})
    p1, p2 = str(tmp_path / "m1.str"), str(tmp_path / "m2.str")
    write_file(p1, t1, options=OPTS)
    write_file(p2, t2, options=OPTS)
    with pytest.raises(OutOfSpecError):
        scan_dataset([p1, p2])


def test_iter_dataset_chunks_covers_all_rows(tmp_path):
    paths, tables = _write_parts(tmp_path, with_strings=False)
    total = 0
    acc = 0
    for chunk in iter_dataset_chunks(paths, chunk_pages=2):
        total += chunk.num_rows
        acc += int(np.asarray(chunk["a"].values).sum())
    exp = pa.concat_tables(tables)
    assert total == exp.num_rows
    assert acc == int(exp.column("a").to_numpy().sum())


def test_empty_dataset_raises(tmp_path):
    from strawboat.errors import OutOfSpecError

    with pytest.raises(OutOfSpecError):
        scan_dataset(str(tmp_path / "nope-*.str"))
    with pytest.raises(OutOfSpecError):
        scan_dataset([])


def test_query_over_dataset_glob(tmp_path):
    """Query() accepts a glob / list: full filter+group_by over many files."""
    from strawboat.exec import Query, col

    paths, tables = _write_parts(tmp_path, with_strings=True)
    res = (
        Query(str(tmp_path / "part-*.str"))
        .filter(col("a") >= 10_000)
        .group_by("s", num_groups=64)
        .agg(total=("sum", "a"), cnt=("count", "a"))
        .run()
    )
    exp = pa.concat_tables(tables)
    a = exp.column("a").to_numpy()
    s = np.asarray(exp.column("s").to_pylist())
    m = a >= 10_000
    import collections

    expected = collections.defaultdict(int)
    for sv, av in zip(s[m], a[m]):
        expected[sv] += int(av)
    n = int(res["n_groups"])
    got = {}
    codes = np.asarray(res["key_s"])[:n]
    # decode group keys through the dictionary shipped with the result
    # (pruning changes the merged dictionary run to run)
    d = res["dict_s"]
    for i in range(n):
        k = d[int(codes[i])].as_py()
        k = k.decode() if isinstance(k, bytes) else k
        got[k] = int(np.asarray(res["total"])[i])
    assert got == dict(expected)


def test_write_dataset_roundtrip(tmp_path):
    """write_dataset -> scan_dataset closes the multi-file loop; each part
    is standalone (own footer + zones) so file-level pruning works."""
    from strawboat.exec.dataset import write_dataset

    n = 1000
    t = pa.table(
        {
            "k": pa.array(np.arange(n, dtype=np.int64)),
            "s": pa.array([f"v{i % 7}" for i in range(n)]),
        }
    )
    d = str(tmp_path / "ds")
    paths = write_dataset(d, t, rows_per_file=256, options=OPTS)
    assert len(paths) == 4
    got = scan_dataset(paths).to_arrow()
    assert got.column("k").to_pylist() == t.column("k").to_pylist()
    assert got.column("s").to_pylist() == t.column("s").to_pylist()
    # a predicate touching one part prunes the other three footer-only
    preds = [Comparison("k", "ge", 512), Comparison("k", "lt", 768)]
    assert [file_may_match(p, preds) for p in paths] == [
        False, False, True, False,
    ]
    dt = scan_dataset(paths, predicates=preds)
    v = np.asarray(dt["k"].values)
    assert v.min() == 512 and v.max() == 767


def test_dataset_concat_decimal_bool_f64(tmp_path):
    """Concat covers every simple column class: decimal(<=18), bool, f64
    (host_exact preserved so materialization stays bit-exact)."""
    from decimal import Decimal

    t1 = pa.table(
        {
            "m": pa.array([Decimal("1.23"), Decimal("4.56")], pa.decimal128(10, 2)),
            "b": pa.array([True, False]),
            "f": pa.array([1.5, 2.25], pa.float64()),
        }
    )
    t2 = pa.table(
        {
            "m": pa.array([Decimal("7.89"), None], pa.decimal128(10, 2)),
            "b": pa.array([None, True]),
            "f": pa.array([3.125, None], pa.float64()),
        }
    )
    p1, p2 = str(tmp_path / "d1.str"), str(tmp_path / "d2.str")
    write_file(p1, t1, options=OPTS)
    write_file(p2, t2, options=OPTS)
    dt = scan_dataset([p1, p2])
    got = dt.to_arrow()
    exp = pa.concat_tables([t1, t2])
    assert got.column("m").to_pylist() == exp.column("m").to_pylist()
    assert got.column("b").to_pylist() == exp.column("b").to_pylist()
    assert got.column("f").to_pylist() == exp.column("f").to_pylist()


def test_manifest_prunes_without_file_reads(tmp_path):
    """Manifest-level pruning decides from the JSON alone (files renamed
    away to prove no file access happens for pruned parts)."""
    import os

    from strawboat.exec.dataset import (
        dataset_manifest,
        load_manifest,
        scan_dataset_with_manifest,
        write_manifest,
    )

    paths, tables = _write_parts(tmp_path, with_strings=False)
    man = dataset_manifest(paths)
    assert [e["num_rows"] for e in man["parts"]] == [700, 700, 700]
    assert man["parts"][0]["columns"]["a"]["min"] >= 0
    mpath = str(tmp_path / "manifest.json")
    write_manifest(man, mpath)
    man2 = load_manifest(mpath)

    # predicate selects only part 1; make parts 0/2 unreadable to prove the
    # manifest pruned them without touching the files
    os.rename(paths[0], paths[0] + ".hidden")
    os.rename(paths[2], paths[2] + ".hidden")
    preds = [Comparison("a", "ge", 10_000), Comparison("a", "lt", 15_000)]
    dt = scan_dataset_with_manifest(man2, predicates=preds)
    got = np.sort(np.asarray(dt["a"].values))
    exp = np.sort(tables[1].column("a").to_numpy())
    np.testing.assert_array_equal(got, exp)


def test_compact_dataset_roundtrip(tmp_path):
    from strawboat.exec.dataset import compact_dataset

    paths, tables = _write_parts(tmp_path, n_files=3, rows=500, with_strings=True)
    out = compact_dataset(
        paths, str(tmp_path / "compacted"), rows_per_file=1500, options=OPTS
    )
    assert len(out) == 1
    got = scan_dataset(out).to_arrow()
    exp = pa.concat_tables(tables)
    assert got.column("a").to_pylist() == exp.column("a").to_pylist()
    assert got.column("s").to_pylist() == exp.column("s").to_pylist()
    # compacted part carries fresh zones: pruning still works
    preds = [Comparison("a", "ge", 10**9)]
    assert not file_may_match(out[0], preds)


def test_query_join_against_dataset_glob(tmp_path):
    """Query.join accepts a glob build side (dataset scan under the hood)."""
    from strawboat.exec import Query, col

    rng = np.random.default_rng(0)
    n = 600
    fact = pa.table(
        {
            "fk": pa.array(rng.integers(0, 40, n).astype(np.int64)),
            "v": pa.array(rng.integers(0, 100, n).astype(np.int64)),
        }
    )
    fpath = str(tmp_path / "fact.str")
    write_file(fpath, fact, options=OPTS)
    # dim table split over two part files
    dim1 = pa.table(
        {
            "dk": pa.array(np.arange(0, 20, dtype=np.int64)),
            "w": pa.array((np.arange(0, 20) * 10).astype(np.int64)),
        }
    )
    dim2 = pa.table(
        {
            "dk": pa.array(np.arange(20, 40, dtype=np.int64)),
            "w": pa.array((np.arange(20, 40) * 10).astype(np.int64)),
        }
    )
    write_file(str(tmp_path / "dim-0.str"), dim1, options=OPTS)
    write_file(str(tmp_path / "dim-1.str"), dim2, options=OPTS)

    res = (
        Query(fpath)
        .join(str(tmp_path / "dim-*.str"), on=("fk", "dk"))
        .group_by("w", num_groups=64)
        .agg(total=("sum", "v"))
        .run()
    )
    ng = int(res["n_groups"])
    got = dict(
        zip(
            np.asarray(res["key_w"])[:ng].tolist(),
            np.asarray(res["total"])[:ng].tolist(),
        )
    )
    fk = fact.column("fk").to_numpy()
    v = fact.column("v").to_numpy()
    w_of = np.concatenate([dim1.column("w").to_numpy(), dim2.column("w").to_numpy()])
    import collections

    exp = collections.defaultdict(int)
    for k, val in zip(fk, v):
        exp[int(w_of[k])] += int(val)
    assert got == dict(exp)
