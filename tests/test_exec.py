"""Device scan/filter/aggregate/join tests (8-device CPU jax via conftest)."""

import numpy as np
import pyarrow as pa
import pyarrow.compute as pc
import pytest

from strawboat.api import write_file
from strawboat.codecs import WriteOptions
from strawboat.constants import Compression


def _opts(**kw):
    return WriteOptions(
        default_compression=Compression.LZ4,
        default_compress_ratio=1.0,
        max_page_size=2048,
        sample_seed=7,
        **kw,
    )


@pytest.fixture
def scan_table(tmp_strawboat):
    rng = np.random.default_rng(3)
    n = 6000
    table = pa.table(
        {
            "onevalue": pa.array(np.full(n, 42, dtype=np.int64)),
            "lowcard": pa.array((rng.integers(0, 6, n) * 1000).astype(np.int64)),
            "runs": pa.array(np.repeat(rng.integers(0, 50, n // 100), 100).astype(np.int64)),
            "bp": pa.array(rng.integers(0, 1 << 14, n, dtype=np.int32)),
            "sorted": pa.array(np.sort(rng.integers(0, 1 << 20, n).astype(np.uint32))),
            "freq": pa.array(np.where(rng.random(n) < 0.95, 10**6, rng.integers(0, 10**9, n)).astype(np.int64)),
            "plain": pa.array(rng.normal(0, 1, n)),
            "nullable": pa.array([int(v) if m else None for v, m in zip(rng.integers(0, 100, n), rng.random(n) > 0.3)], type=pa.int64()),
            "flag": pa.array(rng.random(n) > 0.5),
        }
    )
    write_file(tmp_strawboat, table, options=_opts())
    return tmp_strawboat, table


def test_device_scan_matches_host(scan_table):
    from strawboat.exec import scan_file

    path, table = scan_table
    dt = scan_file(path)
    for name in table.column_names:
        col = table.column(name).combine_chunks()
        dev = dt[name]
        got = np.asarray(dev.values)
        if dev.validity is not None:
            mask = np.asarray(dev.validity)
            exp_mask = ~np.asarray(col.is_null())
            np.testing.assert_array_equal(mask, exp_mask, err_msg=name)
            exp = col.to_numpy(zero_copy_only=False)
            np.testing.assert_array_equal(got[mask], exp[mask].astype(got.dtype), err_msg=name)
        else:
            exp = col.to_numpy(zero_copy_only=False)
            np.testing.assert_array_equal(got, exp.astype(got.dtype), err_msg=name)


def test_filter_aggregate(scan_table):
    import jax.numpy as jnp

    from strawboat.exec import col, scan_file
    from strawboat.exec.aggregate import scalar_aggregate

    path, table = scan_table
    dt = scan_file(path)
    pred = (col("bp") > 5000) & (col("runs") < 25)
    mask = pred.mask(dt)
    exp_mask = (
        table.column("bp").to_numpy() > 5000
    ) & (table.column("runs").to_numpy() < 25)
    np.testing.assert_array_equal(np.asarray(mask), exp_mask)
    s = scalar_aggregate(dt["freq"].values, mask, "sum")
    assert int(s) == int(table.column("freq").to_numpy()[exp_mask].sum())
    c = scalar_aggregate(dt["freq"].values, mask, "count")
    assert int(c) == int(exp_mask.sum())


def test_grouped_aggregate(scan_table):
    from strawboat.exec import hash_aggregate, scan_file

    path, table = scan_table
    dt = scan_file(path)
    res = hash_aggregate(
        dt, keys=["lowcard"], aggs={"total": ("sum", "freq"), "cnt": ("count", "freq")},
        num_groups=64,
    )
    n_groups = int(res["n_groups"])
    assert n_groups == 6
    # compare against pyarrow group-by
    exp = table.group_by("lowcard").aggregate([("freq", "sum"), ("freq", "count")])
    exp_map = {
        int(k): (int(s), int(c))
        for k, s, c in zip(
            exp.column("lowcard").to_pylist(),
            exp.column("freq_sum").to_pylist(),
            exp.column("freq_count").to_pylist(),
        )
    }
    keys = np.asarray(res["keys"])[:n_groups]
    totals = np.asarray(res["total"])[:n_groups]
    cnts = np.asarray(res["cnt"])[:n_groups]
    got_map = {int(k): (int(t), int(c)) for k, t, c in zip(keys, totals, cnts)}
    assert got_map == exp_map


def test_hash_join(tmp_strawboat, tmp_path):
    rng = np.random.default_rng(9)
    n, m = 4000, 64
    fact = pa.table(
        {
            "k": pa.array(rng.integers(0, m, n).astype(np.int64)),
            "v": pa.array(rng.integers(0, 1000, n).astype(np.int64)),
        }
    )
    dim = pa.table(
        {
            "id": pa.array(np.arange(m, dtype=np.int64)),
            "w": pa.array(rng.integers(0, 10, m).astype(np.int64)),
        }
    )
    fpath, dpath = str(tmp_path / "f.str"), str(tmp_path / "d.str")
    write_file(fpath, fact, options=_opts())
    write_file(dpath, dim, options=_opts())

    from strawboat.exec import hash_join, scan_file
    from strawboat.exec.aggregate import scalar_aggregate

    ft = scan_file(fpath)
    dtab = scan_file(dpath)
    pi, bi, valid = hash_join(ft, dtab, on=("k", "id"), max_fanout=1)
    # sum(v * w) over the join
    import jax.numpy as jnp

    prod = ft["v"].values[pi] * dtab["w"].values[bi]
    got = int(scalar_aggregate(prod, valid, "sum"))
    exp = int(
        (fact.column("v").to_numpy() * dim.column("w").to_numpy()[fact.column("k").to_numpy()]).sum()
    )
    assert got == exp


def test_string_column_device_scan(tmp_path):
    import numpy as np
    import pyarrow as pa

    from strawboat.exec import col, scan_file
    from strawboat.exec.aggregate import scalar_aggregate

    rng = np.random.default_rng(11)
    n = 5000
    names = [f"cat-{i%7}" if i % 9 else None for i in range(n)]
    vals = rng.integers(0, 100, n).astype(np.int64)
    table = pa.table({"name": pa.array(names), "v": pa.array(vals)})
    path = str(tmp_path / "s.str")
    write_file(path, table, options=_opts())
    dt = scan_file(path)
    assert dt["name"].dictionary is not None
    mask = (col("name") == "cat-3").mask(dt)
    exp = np.array([x == "cat-3" for x in names])
    np.testing.assert_array_equal(np.asarray(mask), exp)
    got = int(scalar_aggregate(dt["v"].values, mask, "sum"))
    assert got == int(vals[exp].sum())
    # isin + ne
    m2 = col("name").isin(["cat-1", "cat-5"]).mask(dt)
    exp2 = np.array([x in ("cat-1", "cat-5") for x in names])
    np.testing.assert_array_equal(np.asarray(m2), exp2)
    m3 = (col("name") != "cat-0").mask(dt)
    exp3 = np.array([x is not None and x != "cat-0" for x in names])
    np.testing.assert_array_equal(np.asarray(m3), exp3)


def test_nested_column_device_scan(tmp_path):
    import numpy as np
    import pyarrow as pa

    from strawboat.exec import scan_file
    from strawboat.exec.scan import DeviceListColumn

    n = 2000
    table = pa.table(
        {
            "l": pa.array(
                [[i, i + 1] if i % 3 else None for i in range(n)],
                type=pa.list_(pa.int64()),
            ),
            "s": pa.array(
                [{"a": i, "b": float(i) * 0.5} for i in range(n)],
                type=pa.struct([("a", pa.int64()), ("b", pa.float64())]),
            ),
        }
    )
    path = str(tmp_path / "n.str")
    write_file(path, table, options=_opts())
    dt = scan_file(path)
    lc = dt["l"]
    assert isinstance(lc, DeviceListColumn)
    assert len(lc) == n
    offs = np.asarray(lc.offsets)
    vals = np.asarray(lc.values)
    exp = [x for i in range(n) if i % 3 for x in (i, i + 1)]
    np.testing.assert_array_equal(vals, exp)
    # struct unnested to dotted columns
    np.testing.assert_array_equal(np.asarray(dt["s.a"].values), np.arange(n))
    np.testing.assert_allclose(np.asarray(dt["s.b"].values), np.arange(n) * 0.5)


def test_query_api(tmp_path):
    import numpy as np
    import pyarrow as pa

    from strawboat.exec import col
    from strawboat.exec.query import Query

    rng = np.random.default_rng(21)
    n = 8192
    k = rng.integers(0, 5, n).astype(np.int64)
    v = rng.integers(0, 1000, n).astype(np.int64)
    d = np.sort(rng.integers(0, 1000, n)).astype(np.int64)
    table = pa.table({"k": pa.array(k), "v": pa.array(v), "d": pa.array(d)})
    path = str(tmp_path / "q.str")
    write_file(path, table, options=_opts(zone_maps=True))

    pred = (col("d") >= 300) & (col("d") < 600)
    assert len(pred.atoms) == 2  # auto-extracted pruning atoms

    res = (
        Query(path)
        .filter(pred)
        .group_by("k", num_groups=32)
        .agg(total=("sum", "v"), cnt=("count", "v"))
        .run()
    )
    sel = (d >= 300) & (d < 600)
    n_groups = int(res["n_groups"])
    got = {
        int(kk): (int(t), int(c))
        for kk, t, c in zip(
            np.asarray(res["keys"])[:n_groups],
            np.asarray(res["total"])[:n_groups],
            np.asarray(res["cnt"])[:n_groups],
        )
    }
    exp = {
        int(kk): (int(v[sel & (k == kk)].sum()), int((sel & (k == kk)).sum()))
        for kk in np.unique(k[sel])
    }
    assert got == exp

    # ungrouped
    res2 = Query(path).filter(pred).agg(s=("sum", "v")).run()
    assert int(res2["s"]) == int(v[sel].sum())


def test_device_table_to_arrow(tmp_path):
    import numpy as np
    import pyarrow as pa

    from strawboat.exec import col, scan_file

    rng = np.random.default_rng(31)
    n = 3000
    table = pa.table(
        {
            "a": pa.array(rng.integers(0, 100, n).astype(np.int64)),
            "s": pa.array([f"v{i%4}" if i % 7 else None for i in range(n)]),
            "b": pa.array(rng.random(n) > 0.5),
        }
    )
    path = str(tmp_path / "m.str")
    write_file(path, table, options=_opts())
    dt = scan_file(path)
    mask = (col("a") > 50).mask(dt)
    got = dt.to_arrow(mask)
    sel = table.column("a").to_numpy() > 50
    exp_a = table.column("a").to_numpy()[sel]
    np.testing.assert_array_equal(got.column("a").to_numpy(), exp_a)
    exp_s = [s for s, m in zip(table.column("s").to_pylist(), sel) if m]
    assert got.column("s").to_pylist() == exp_s
    exp_b = table.column("b").to_numpy()[sel]
    np.testing.assert_array_equal(got.column("b").to_numpy(zero_copy_only=False), exp_b)


@pytest.mark.parametrize("dtype", [np.int64, np.int32, np.float64])
def test_join_indices_null_build_rows_never_count(dtype):
    """Null build rows sharing a key (an exchange's padding) neither match
    nor widen the fan-out: max_run counts valid rows only."""
    import jax.numpy as jnp

    from strawboat.exec.join import _join_indices

    bk = np.array([5, 0, 0, 0, 0, 0, 3], dtype)
    bv = np.array([1, 0, 0, 0, 0, 1, 1], bool)
    pk = np.array([0, 3, 5, 7, 0], dtype)
    pi, bi, ok, max_run = _join_indices(
        jnp.asarray(bk), jnp.asarray(pk), 1, jnp.asarray(bv)
    )
    assert int(max_run) == 1
    got = sorted(zip(np.asarray(pi)[np.asarray(ok)].tolist(),
                     np.asarray(bi)[np.asarray(ok)].tolist()))
    assert got == [(0, 5), (1, 6), (2, 0), (4, 5)]


def test_hash_join_duplicate_build_keys(tmp_path):
    import numpy as np
    import pyarrow as pa

    from strawboat.exec import hash_join, scan_file
    from strawboat.exec.aggregate import scalar_aggregate

    rng = np.random.default_rng(13)
    n, m = 2000, 300
    probe = pa.table({"k": pa.array(rng.integers(0, 50, n).astype(np.int64))})
    build_keys = rng.integers(0, 50, m).astype(np.int64)  # duplicates
    build = pa.table(
        {"k": pa.array(build_keys), "w": pa.array(rng.integers(1, 5, m).astype(np.int64))}
    )
    pp, bp_ = str(tmp_path / "p.str"), str(tmp_path / "b.str")
    write_file(pp, probe, options=_opts())
    write_file(bp_, build, options=_opts())
    pt, bt = scan_file(pp), scan_file(bp_)
    fan = int(np.bincount(build_keys).max())
    pi, bi, valid = hash_join(pt, bt, on=("k", "k"), max_fanout=fan)
    got = int(scalar_aggregate(bt["w"].values[bi], valid, "sum"))
    pk = probe.column("k").to_numpy()
    exp = sum(
        int(build.column("w").to_numpy()[build_keys == k].sum()) for k in pk
    )
    assert got == exp


def test_hash_aggregate_key_columns(scan_table):
    from strawboat.exec import hash_aggregate, scan_file

    path, table = scan_table
    dt = scan_file(path)
    res = hash_aggregate(
        dt, keys=["lowcard"], aggs={"total": ("sum", "freq")}, num_groups=64
    )
    n = int(res["n_groups"])
    keys_dec = np.asarray(res["key_lowcard"])[:n]
    keys_raw = np.asarray(res["keys"])[:n]
    np.testing.assert_array_equal(np.sort(keys_dec.astype(np.uint64)), np.sort(keys_raw))


def test_list_segment_sum(tmp_path):
    import pyarrow as pa

    from strawboat.exec import scan_file
    from strawboat.exec.aggregate import list_segment_sum

    n = 500
    data = [[i, i + 1, i + 2] if i % 4 else ([] if i % 2 else None) for i in range(n)]
    table = pa.table({"l": pa.array(data, type=pa.list_(pa.int64()))})
    path = str(tmp_path / "ls.str")
    write_file(path, table, options=_opts())
    dt = scan_file(path)
    lc = dt["l"]
    sums = np.asarray(list_segment_sum(lc.values, lc.offsets, len(lc)))
    exp = [sum(x) if x else 0 for x in (d or [] for d in data)]
    np.testing.assert_array_equal(sums, exp)


def test_scan_chunks_streaming(tmp_path):
    import numpy as np
    import pyarrow as pa

    from strawboat.exec.scan import scan_chunks

    rng = np.random.default_rng(41)
    n = 10000
    k = rng.integers(0, 9, n).astype(np.int64)
    v = rng.integers(0, 10**6, n).astype(np.int64)
    table = pa.table({"k": pa.array(k), "v": pa.array(v)})
    path = str(tmp_path / "c.str")
    opts = _opts()
    opts.max_page_size = 1024
    write_file(path, table, options=opts)
    total_rows = 0
    total_v = 0
    n_chunks = 0
    for dt in scan_chunks(path, chunk_pages=3):
        total_rows += len(dt["v"])
        total_v += int(np.asarray(dt["v"].values).sum())
        n_chunks += 1
    assert total_rows == n
    assert total_v == int(v.sum())
    assert n_chunks == 4  # ceil(10 pages / 3)


def test_decimal_device_scan_and_filter(tmp_path):
    """decimal columns scan to unscaled int64 and filter as money ints."""
    from decimal import Decimal

    import numpy as np

    from strawboat.api import write_file
    from strawboat.codecs import WriteOptions
    from strawboat.constants import Compression
    from strawboat.exec import col, scan_file

    vals = [Decimal("1.00"), Decimal("2.50"), None, Decimal("-3.75")] * 200
    table = pa.table({"d": pa.array(vals, pa.decimal128(10, 2))})
    path = str(tmp_path / "dec.str")
    write_file(
        path,
        table,
        options=WriteOptions(
            default_compression=Compression.LZ4, max_page_size=128
        ),
    )
    dt = scan_file(path)
    assert dt["d"].values.dtype == np.int64
    assert dt.to_arrow().column("d").to_pylist() == vals
    mask = (col("d") > 100).mask(dt)  # unscaled cents
    assert int(np.asarray(mask).sum()) == 200  # the 2.50 rows


def test_query_join_group_by(tmp_path):
    """Q3-shaped query through the fluent API: lineitem ⋈ orders, build-side
    date filter, revenue grouped by order priority — vs numpy."""
    import numpy as np

    from strawboat.api import write_file
    from strawboat.benchsuite.tpch import generate_lineitem, generate_orders
    from strawboat.codecs import WriteOptions
    from strawboat.constants import Compression
    from strawboat.exec import Query, col

    li = generate_lineitem(0.001)
    orders = generate_orders(0.001)
    lp = str(tmp_path / "li.str")
    op = str(tmp_path / "o.str")
    opts = WriteOptions(default_compression=Compression.LZ4, max_page_size=1024)
    write_file(lp, li, options=opts)
    write_file(op, orders, options=opts)

    res = (
        Query(lp)
        .join(Query(op).filter(col("o_orderdate") < 1000),
              on=("l_orderkey", "o_orderkey"))
        .group_by("o_orderpriority", num_groups=64)
        .agg(revenue=("sum", col("l_extendedprice") * (100 - col("l_discount"))))
        .run()
    )
    n = int(res["n_groups"])
    got = dict(
        zip(
            np.asarray(res["key_o_orderpriority"])[:n].tolist(),
            np.asarray(res["revenue"])[:n].tolist(),
        )
    )

    # numpy reference
    lk = np.asarray(li.column("l_orderkey"))
    ep = np.asarray(li.column("l_extendedprice"))
    disc = np.asarray(li.column("l_discount"))
    odate = np.asarray(orders.column("o_orderdate"))
    oprio = np.asarray(orders.column("o_orderpriority"))
    ok = np.asarray(orders.column("o_orderkey"))
    pos = np.searchsorted(ok, lk)
    matched = (pos < len(ok)) & (ok[np.clip(pos, 0, len(ok) - 1)] == lk)
    matched &= odate[np.clip(pos, 0, len(ok) - 1)] < 1000
    rev = ep * (100 - disc)
    ref = {}
    for g in np.unique(oprio):
        m = matched & (oprio[np.clip(pos, 0, len(ok) - 1)] == g)
        if m.any():
            ref[int(g)] = int(rev[m].sum())
    assert got == ref


def test_query_join_name_conflict_raises(tmp_path):
    import pyarrow as pa

    from strawboat.api import write_file
    from strawboat.codecs import WriteOptions
    from strawboat.constants import Compression
    from strawboat.errors import OutOfSpecError
    from strawboat.exec import Query

    t = pa.table({"k": pa.array([1, 2, 3], pa.int64())})
    p1, p2 = str(tmp_path / "a.str"), str(tmp_path / "b.str")
    opts = WriteOptions(default_compression=Compression.LZ4)
    write_file(p1, t, options=opts)
    write_file(p2, t, options=opts)
    with pytest.raises(OutOfSpecError):
        Query(p1).join(p2, on=("k", "k")).group_by("k").agg(
            c=("count", "k")
        ).run()


def test_string_range_comparisons(tmp_path):
    """Lexical <,<=,>,>= on dictionary-coded utf8 columns (rank remap)."""
    import os

    import numpy as np

    from strawboat.api import write_file
    from strawboat.codecs import WriteOptions
    from strawboat.constants import Compression
    from strawboat.exec import col, scan_file

    rng = np.random.default_rng(0)
    words = ["apple", "banana", "cherry", "date", "elderberry"]
    vals = [words[i] for i in rng.integers(0, len(words), 2000)]
    t = pa.table({"s": pa.array(vals, pa.string())})
    path = str(tmp_path / "s.str")
    os.environ["STRAWBOAT_DICT_COMPRESSION"] = "1"
    try:
        write_file(
            path,
            t,
            options=WriteOptions(
                default_compression=Compression.LZ4, max_page_size=512
            ),
        )
    finally:
        del os.environ["STRAWBOAT_DICT_COMPRESSION"]
    dt = scan_file(path)
    arr = np.asarray(vals)
    for expr, ref in [
        (col("s") < "cherry", arr < "cherry"),
        (col("s") <= "cherry", arr <= "cherry"),
        (col("s") > "cherry", arr > "cherry"),
        (col("s") >= "cherry", arr >= "cherry"),
        (col("s") < "blueberry", arr < "blueberry"),  # literal not in dict
        (col("s") >= "zzz", arr >= "zzz"),  # above all
    ]:
        got = np.asarray(expr.mask(dt))
        assert np.array_equal(got, ref)
