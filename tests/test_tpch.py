"""TPC-H workload tests (BASELINE config 4 shape, small scale): write
lineitem with utf8 flag columns, device scan with zone-map pruning, full Q1
(all 8 aggregates) / Q6 vs numpy references on all three execution paths."""

import numpy as np
import pytest

from strawboat.api import write_file
from strawboat.benchsuite.tpch import (
    generate_lineitem,
    q1,
    q1_dense,
    q1_numpy_reference,
    q1_query,
    q6,
    q6_numpy_reference,
    q6_pruning_predicates,
)
from strawboat.codecs import WriteOptions
from strawboat.constants import Compression
from strawboat.exec import scan_file


@pytest.fixture(scope="module")
def lineitem_file(tmp_path_factory):
    table = generate_lineitem(scale=0.01, rows=60_000)
    path = str(tmp_path_factory.mktemp("tpch") / "lineitem.str")
    write_file(
        path,
        table,
        options=WriteOptions(
            default_compression=Compression.LZ4,
            default_compress_ratio=1.0,
            max_page_size=8192,
            sample_seed=1,
            zone_maps=True,
        ),
    )
    return path, table


def test_q6(lineitem_file):
    path, table = lineitem_file
    dt = scan_file(path)
    got = int(q6(dt))
    assert got == q6_numpy_reference(table)


def test_q6_with_pruning(lineitem_file):
    path, table = lineitem_file
    dt = scan_file(path, predicates=q6_pruning_predicates())
    # fewer rows decoded (shipdate is clustered so pruning bites)
    assert len(dt["l_shipdate"]) < table.num_rows
    got = int(q6(dt))
    assert got == q6_numpy_reference(table)


def _assert_q1_matches(got_table, exp):
    rows = got_table.to_pylist()
    assert len(rows) == len(exp)
    for row in rows:
        key = (row["l_returnflag"], row["l_linestatus"])
        e = exp[key]
        for name in (
            "sum_qty",
            "sum_base_price",
            "sum_disc_price",
            "sum_charge",
            "count_order",
        ):
            assert int(row[name]) == e[name], (key, name)
        for name in ("avg_qty", "avg_price", "avg_disc"):
            assert abs(row[name] - e[name]) < 1e-9 * max(abs(e[name]), 1), (
                key,
                name,
            )
    # output ordered by (returnflag, linestatus)
    keys = [(r["l_returnflag"], r["l_linestatus"]) for r in rows]
    assert keys == sorted(keys)


def test_q1_full(lineitem_file):
    """All 8 Q1 aggregates, utf8 group keys, sort-based path."""
    path, table = lineitem_file
    dt = scan_file(path)
    exp = q1_numpy_reference(table)
    _assert_q1_matches(q1(dt), exp)


def test_q1_dense_path(lineitem_file):
    """Dense-code matmul path produces identical results."""
    path, table = lineitem_file
    dt = scan_file(path)
    exp = q1_numpy_reference(table)
    _assert_q1_matches(q1_dense(dt), exp)


def test_q1_query_api(lineitem_file):
    """Q1 through the fluent Query API with ORDER BY on string keys."""
    path, table = lineitem_file
    res = q1_query(path)
    exp = q1_numpy_reference(table)
    valid = np.asarray(res["taken_valid"])
    n = int(valid.sum())
    assert n == len(exp)
    # keys come back as dictionary codes; decode through a scan's dictionary
    dt = scan_file(path, columns=["l_returnflag", "l_linestatus"])
    fd = dt["l_returnflag"].dictionary
    sd = dt["l_linestatus"].dictionary

    def dec(d, c):
        v = d[int(c)].as_py()
        return v.decode() if isinstance(v, bytes) else v

    keys = [
        (dec(fd, f), dec(sd, s))
        for f, s in zip(
            np.asarray(res["key_l_returnflag"])[:n],
            np.asarray(res["key_l_linestatus"])[:n],
        )
    ]
    # ORDER BY on dictionary keys is lexical
    assert keys == sorted(keys)
    for i, key in enumerate(keys):
        e = exp[key]
        assert int(np.asarray(res["sum_qty"])[i]) == e["sum_qty"]
        assert int(np.asarray(res["sum_disc_price"])[i]) == e["sum_disc_price"]
        assert int(np.asarray(res["sum_charge"])[i]) == e["sum_charge"]
        assert int(np.asarray(res["count_order"])[i]) == e["count_order"]
        assert abs(float(np.asarray(res["avg_disc"])[i]) - e["avg_disc"]) < 1e-9


def test_string_filter_on_flags(lineitem_file):
    """utf8 literal predicates translate through the device dictionary."""
    from strawboat.exec import Query, col

    path, table = lineitem_file
    res = Query(path).filter(col("l_returnflag") == "R").agg(
        n=("count", "l_quantity")
    ).run()
    rf = np.asarray(table.column("l_returnflag").to_pylist())
    assert int(res["n"]) == int((rf == "R").sum())


def test_q3_like_join(tmp_path):
    from strawboat.benchsuite.tpch import generate_orders, q3_like

    li = generate_lineitem(0.01, rows=40_000)
    orders = generate_orders(0.01, rows=10_000)
    lp = str(tmp_path / "li.str")
    op = str(tmp_path / "ord.str")
    opts = WriteOptions(
        default_compression=Compression.LZ4,
        default_compress_ratio=1.0,
        max_page_size=8192,
        sample_seed=2,
    )
    write_file(lp, li, options=opts)
    write_file(op, orders, options=opts)
    lt = scan_file(lp)
    ot = scan_file(op)
    uniq, n_groups, total = q3_like(lt, ot, date_cut=1000, num_groups=16)
    n_groups = int(n_groups)
    got = {
        int(k): int(t)
        for k, t in zip(
            np.asarray(uniq)[:n_groups], np.asarray(total)[:n_groups]
        )
    }
    # numpy reference
    ok = li.column("l_orderkey").to_numpy()
    ep = li.column("l_extendedprice").to_numpy()
    disc = li.column("l_discount").to_numpy()
    od = orders.column("o_orderdate").to_numpy()
    pr = orders.column("o_orderpriority").to_numpy()
    sel = od[ok] < 1000
    rev = ep * (100 - disc)
    exp = {}
    for p in np.unique(pr):
        m = sel & (pr[ok] == p)
        if m.any():
            exp[int(p)] = int(rev[m].sum())
    assert got == exp
