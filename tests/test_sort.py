"""ORDER BY / LIMIT / DISTINCT / avg tests (CPU jax via conftest)."""

import numpy as np
import pyarrow as pa
import pytest

from strawboat.api import write_file
from strawboat.codecs import WriteOptions
from strawboat.constants import Compression


def _opts():
    return WriteOptions(
        default_compression=Compression.LZ4,
        default_compress_ratio=1.0,
        max_page_size=2048,
        sample_seed=7,
    )


@pytest.fixture
def sort_file(tmp_strawboat):
    rng = np.random.default_rng(11)
    n = 5000
    table = pa.table(
        {
            "i": pa.array(rng.integers(-(10**9), 10**9, n).astype(np.int64)),
            "u": pa.array(rng.integers(0, 1 << 20, n).astype(np.uint32)),
            "f": pa.array(rng.normal(0, 100, n)),
            "g": pa.array(rng.integers(0, 7, n).astype(np.int64)),
            "v": pa.array(rng.integers(0, 1000, n).astype(np.int64)),
        }
    )
    write_file(tmp_strawboat, table, options=_opts())
    return tmp_strawboat, table


def test_orderable_u64_matches_numpy_order():
    import jax.numpy as jnp

    from strawboat.exec.sort import orderable_u64

    rng = np.random.default_rng(0)
    ints = rng.integers(-(10**12), 10**12, 500).astype(np.int64)
    floats = np.concatenate(
        [rng.normal(0, 1e6, 500), [0.0, -0.0, np.inf, -np.inf]]
    )
    for arr in (ints, floats, ints.astype(np.int32), floats.astype(np.float32)):
        keys = np.asarray(orderable_u64(jnp.asarray(arr)))
        order_keys = np.argsort(keys, kind="stable")
        order_vals = np.argsort(arr, kind="stable")
        np.testing.assert_array_equal(arr[order_keys], arr[order_vals])
        # descending
        keys_d = np.asarray(orderable_u64(jnp.asarray(arr), descending=True))
        np.testing.assert_array_equal(
            arr[np.argsort(keys_d, kind="stable")], np.sort(arr)[::-1]
        )


def test_sort_indices_multicol_and_mask():
    import jax.numpy as jnp

    from strawboat.exec.sort import sort_indices

    rng = np.random.default_rng(1)
    a = rng.integers(0, 5, 1000).astype(np.int64)
    b = rng.normal(0, 1, 1000)
    mask = rng.random(1000) > 0.3
    idx = np.asarray(
        sort_indices(
            (jnp.asarray(a), jnp.asarray(b)),
            (False, True),
            jnp.asarray(mask),
        )
    )
    n_valid = mask.sum()
    taken = idx[:n_valid]
    # valid rows first, ordered by (a asc, b desc)
    assert mask[taken].all() and not mask[idx[n_valid:]].any()
    exp = np.lexsort((-b[mask], a[mask]))
    np.testing.assert_array_equal(a[taken], a[mask][exp])
    np.testing.assert_array_equal(b[taken], b[mask][exp])


def test_topk_fast_path_matches_full_sort():
    import jax.numpy as jnp

    from strawboat.exec.sort import sort_indices

    rng = np.random.default_rng(2)
    v = rng.integers(-(10**9), 10**9, 4096).astype(np.int64)
    idx = np.asarray(sort_indices((jnp.asarray(v),), (False,), None, limit=10))
    np.testing.assert_array_equal(v[idx], np.sort(v)[:10])
    idx_d = np.asarray(sort_indices((jnp.asarray(v),), (True,), None, limit=10))
    np.testing.assert_array_equal(v[idx_d], np.sort(v)[::-1][:10])


def test_query_order_by_limit(sort_file):
    from strawboat.exec import Query, col

    path, table = sort_file
    res, taken_valid = (
        Query(path)
        .select("i", "f")
        .filter(col("f") > 0)
        .order_by(("i", "desc"))
        .limit(25)
        .run()
    )
    f = table.column("f").to_numpy()
    i = table.column("i").to_numpy()
    sel = f > 0
    exp = np.sort(i[sel])[::-1][:25]
    np.testing.assert_array_equal(np.asarray(res["i"].values), exp)
    assert np.asarray(taken_valid).all()


def test_query_grouped_avg_ordered(sort_file):
    from strawboat.exec import Query

    path, table = sort_file
    res = (
        Query(path)
        .group_by("g", num_groups=64)
        .agg(mean_v=("avg", "v"), total=("sum", "v"))
        .order_by(("total", "desc"))
        .limit(3)
        .run()
    )
    g = table.column("g").to_numpy()
    v = table.column("v").to_numpy()
    sums = {k: v[g == k].sum() for k in np.unique(g)}
    means = {k: v[g == k].mean() for k in np.unique(g)}
    top = sorted(sums.items(), key=lambda kv: -kv[1])[:3]
    got_keys = np.asarray(res["key_g"])
    got_tot = np.asarray(res["total"])
    got_mean = np.asarray(res["mean_v"])
    for j, (k, s) in enumerate(top):
        assert got_keys[j] == k
        assert got_tot[j] == s
        np.testing.assert_allclose(got_mean[j], means[k])
    assert np.asarray(res["taken_valid"])[:3].all()


def test_query_distinct(sort_file):
    from strawboat.exec import Query

    path, table = sort_file
    res = Query(path).select("g").distinct(num_groups=64).run()
    n = int(res["n_groups"])
    got = np.sort(np.asarray(res["key_g"])[:n])
    np.testing.assert_array_equal(got, np.unique(table.column("g").to_numpy()))


def test_query_limit_only_with_filter(sort_file):
    from strawboat.exec import Query, col

    path, table = sort_file
    res, taken = Query(path).select("u").filter(col("u") < 1000).limit(5).run()
    u = table.column("u").to_numpy()
    exp = u[u < 1000][:5]
    # host-compacted: taken is None and every returned row is real (no
    # padded duplicates of row 0 when fewer than limit rows survive)
    assert taken is None
    got = np.asarray(res["u"].values)
    np.testing.assert_array_equal(got, exp)


def test_order_by_string_is_lexical(tmp_strawboat):
    """Dictionary codes are first-occurrence order; ORDER BY must still be
    byte-lexical (round-1 advisor finding: code-order sorts were wrong)."""
    from strawboat.exec import Query

    rng = np.random.default_rng(13)
    # first occurrences deliberately non-lexical: "zeta" gets code 0
    words = ["zeta", "alpha", "mike", "bravo", "yank", "charlie"]
    vals = [words[i] for i in rng.integers(0, len(words), 800)]
    vals[0] = "zeta"
    table = pa.table({"s": pa.array(vals, pa.string()),
                      "x": pa.array(np.arange(800, dtype=np.int64))})
    write_file(tmp_strawboat, table, options=_opts())
    res, taken = Query(tmp_strawboat).select("s", "x").order_by("s").run()
    got = res.to_arrow().column("s").to_pylist()
    assert got == sorted(vals)
    # grouped path: ORDER BY key_s on a grouped aggregate is lexical too
    resg = (
        Query(tmp_strawboat)
        .group_by("s", num_groups=16)
        .agg(total=("sum", "x"))
        .order_by("key_s")
        .run()
    )
    n = int(resg["n_groups"])
    codes = np.asarray(resg["key_s"])[:n]
    # decode via a fresh scan's dictionary
    t = Query(tmp_strawboat).scan()
    d = t["s"].dictionary
    names = [d[int(c)].as_py().decode() if isinstance(d[int(c)].as_py(), bytes)
             else d[int(c)].as_py() for c in codes]
    assert names == sorted(set(vals))


def test_projection_pushdown_under_filter(tmp_strawboat):
    """Filtered+grouped queries decode only referenced columns (round-1
    verdict: filters used to force scanning every column)."""
    from strawboat.exec import Query, col

    rng = np.random.default_rng(17)
    n = 1000
    table = pa.table({k: pa.array(rng.integers(0, 100, n).astype(np.int64))
                      for k in ("a", "b", "c", "d", "e")})
    write_file(tmp_strawboat, table, options=_opts())
    q = (
        Query(tmp_strawboat)
        .filter(col("c") > 10)
        .group_by("a", num_groups=128)
        .agg(total=("sum", "b"))
    )
    t = q.scan()
    assert set(t.columns.keys()) == {"a", "b", "c"}
    # and the query itself is still correct
    res = q.run()
    ngrp = int(res["n_groups"])
    a = table.column("a").to_numpy()
    b = table.column("b").to_numpy()
    c = table.column("c").to_numpy()
    exp = {int(k): int(b[(a == k) & (c > 10)].sum())
           for k in np.unique(a[c > 10])}
    got = {int(k): int(v) for k, v in zip(np.asarray(res["key_a"])[:ngrp],
                                          np.asarray(res["total"])[:ngrp])}
    assert got == exp


def test_select_does_not_leak_order_column(sort_file):
    from strawboat.exec import Query

    path, table = sort_file
    res, taken = Query(path).select("i").order_by("f").limit(10).run()
    assert set(res.columns.keys()) == {"i"}
