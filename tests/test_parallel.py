"""Multi-device tests on the virtual 8-device CPU mesh (SURVEY §4: the
multi-host test model is shard_map simulation — no reference counterpart)."""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from strawboat.parallel import (
    distributed_aggregate,
    hash_partition_ids,
    make_mesh,
    shuffle_by_key,
)


@pytest.fixture(scope="module")
def mesh():
    assert jax.device_count() >= 8, "expected 8 virtual CPU devices"
    return make_mesh(8)


def _shard(mesh, arr):
    from jax.sharding import NamedSharding, PartitionSpec as P

    return jax.device_put(arr, NamedSharding(mesh, P("shards")))


def test_shuffle_brings_equal_keys_together(mesh):
    rng = np.random.default_rng(0)
    n = 8 * 512
    key = rng.integers(0, 50, n).astype(np.int64)
    val = rng.integers(0, 1000, n).astype(np.int64)
    k = _shard(mesh, jnp.asarray(key))
    v = _shard(mesh, jnp.asarray(val))
    out_key, (out_val,), valid = shuffle_by_key(mesh, "shards", k, (v,), capacity=512)
    ok, ov, om = np.asarray(out_key), np.asarray(out_val), np.asarray(valid)
    # all rows survive (no overflow at this capacity)
    assert om.sum() == n
    # every key lands on exactly one shard
    per_shard = ok.reshape(8, -1)
    per_mask = om.reshape(8, -1)
    owner = {}
    for s in range(8):
        for kk in np.unique(per_shard[s][per_mask[s]]):
            assert owner.setdefault(int(kk), s) == s
    # multiset of (key, val) pairs preserved
    got = sorted(zip(ok[om].tolist(), ov[om].tolist()))
    exp = sorted(zip(key.tolist(), val.tolist()))
    assert got == exp


def test_distributed_aggregate_matches_single_device(mesh):
    rng = np.random.default_rng(1)
    n = 8 * 1024
    key = rng.integers(0, 40, n).astype(np.int64)
    val = rng.integers(0, 10**6, n).astype(np.int64)
    k = _shard(mesh, jnp.asarray(key))
    v = _shard(mesh, jnp.asarray(val))
    res = distributed_aggregate(
        mesh, "shards", k, {"total": ("sum", v), "mx": ("max", v)}, num_groups=256
    )
    keys = np.asarray(res["keys"])
    valid = np.asarray(res["valid"])
    totals = np.asarray(res["total"])
    mxs = np.asarray(res["mx"])
    got = {}
    for kk, t, m, ok in zip(keys, totals, mxs, valid):
        if ok:
            assert int(kk) not in got, "key appears on two shards"
            got[int(kk)] = (int(t), int(m))
    exp = {}
    for kk in np.unique(key):
        sel = key == kk
        exp[int(kk)] = (int(val[sel].sum()), int(val[sel].max()))
    assert got == exp


def test_skew_salting_spreads_hot_key(mesh):
    n = 8 * 256
    key = jnp.zeros(n, dtype=jnp.int64)  # one hot key
    parts_plain = hash_partition_ids(key, 8)
    parts_salted = hash_partition_ids(key, 8, salt=8)
    assert len(np.unique(np.asarray(parts_plain))) == 1
    assert len(np.unique(np.asarray(parts_salted))) == 8


def test_distributed_scan_aggregate_end_to_end(mesh, tmp_path):
    """Config-5 shape: partitioned file scan → shuffle → distributed agg."""
    import pyarrow as pa

    from strawboat.api import write_file
    from strawboat.codecs import WriteOptions
    from strawboat.constants import Compression
    from strawboat.parallel.dist_scan import distributed_scan

    rng = np.random.default_rng(4)
    n = 8 * 1500
    key = rng.integers(0, 30, n).astype(np.int64)
    val = rng.integers(0, 10**6, n).astype(np.int64)
    table = pa.table({"k": pa.array(key), "v": pa.array(val)})
    path = str(tmp_path / "dist.str")
    write_file(
        path,
        table,
        options=WriteOptions(
            default_compression=Compression.LZ4,
            default_compress_ratio=1.0,
            max_page_size=512,
        ),
    )
    dt = distributed_scan(path, mesh)
    res = distributed_aggregate(
        mesh,
        "shards",
        dt["k"].values,
        {"total": ("sum", dt["v"].values)},
        mask=dt["__valid__"].values,
        num_groups=128,
    )
    got = {}
    for kk, t, ok in zip(
        np.asarray(res["keys"]), np.asarray(res["total"]), np.asarray(res["valid"])
    ):
        if ok:
            got[int(kk)] = int(t)
    exp = {int(k): int(val[key == k].sum()) for k in np.unique(key)}
    assert got == exp


def test_pipelined_aggregate_matches(mesh):
    from strawboat.parallel.pipeline import pipelined_distributed_aggregate

    rng = np.random.default_rng(7)
    n_chunks, per_chunk = 3, 8 * 512
    keys_all, vals_all = [], []
    chunks = []
    for c in range(n_chunks):
        k = rng.integers(0, 25, per_chunk).astype(np.int64)
        v = rng.integers(0, 10**5, per_chunk).astype(np.int64)
        keys_all.append(k)
        vals_all.append(v)
        chunks.append(
            (
                _shard(mesh, jnp.asarray(k)),
                {"total": ("sum", _shard(mesh, jnp.asarray(v)))},
                None,
            )
        )
    res = pipelined_distributed_aggregate(mesh, "shards", chunks, num_groups=128)
    got = {}
    for kk, t, ok in zip(
        np.asarray(res["keys"]), np.asarray(res["total"]), np.asarray(res["valid"])
    ):
        if ok:
            assert int(kk) not in got
            got[int(kk)] = int(t)
    key = np.concatenate(keys_all)
    val = np.concatenate(vals_all)
    exp = {int(k): int(val[key == k].sum()) for k in np.unique(key)}
    assert got == exp


def test_distributed_join_matches(mesh):
    from strawboat.parallel.dist_join import distributed_join

    rng = np.random.default_rng(17)
    n, m = 8 * 512, 8 * 64
    pk = rng.integers(0, 200, n).astype(np.int64)
    pv = rng.integers(0, 1000, n).astype(np.int64)
    bk_unique = rng.permutation(512)[:m].astype(np.int64)  # unique build keys
    bw = rng.integers(1, 10, m).astype(np.int64)
    key, out_p, out_b, valid = distributed_join(
        mesh,
        "shards",
        _shard(mesh, jnp.asarray(pk)),
        (_shard(mesh, jnp.asarray(pv)),),
        _shard(mesh, jnp.asarray(bk_unique)),
        (_shard(mesh, jnp.asarray(bw)),),
        capacity_per_shard=512,
    )
    v = np.asarray(valid)
    got = int((np.asarray(out_p[0])[v] * np.asarray(out_b[0])[v]).sum())
    # numpy reference
    wmap = {int(k): int(w) for k, w in zip(bk_unique, bw)}
    exp = sum(int(val) * wmap[int(k)] for k, val in zip(pk, pv) if int(k) in wmap)
    assert got == exp
    assert int(v.sum()) == sum(1 for k in pk if int(k) in wmap)


def test_distributed_scan_string_and_bool_columns(mesh, tmp_path):
    """String columns ride as global-dictionary codes; booleans as values;
    nullable validity shards alongside (VERDICT r2 missing #1)."""
    import pyarrow as pa

    from strawboat.api import write_file
    from strawboat.codecs import WriteOptions
    from strawboat.constants import Compression
    from strawboat.parallel.dist_scan import distributed_scan

    rng = np.random.default_rng(7)
    n = 8 * 600
    cats = np.array([b"alpha", b"beta", b"gamma", b"delta"], dtype=object)
    sidx = rng.integers(0, 4, n)
    s = pa.array([cats[i].decode() for i in sidx], pa.string())
    b = pa.array(rng.integers(0, 2, n).astype(bool))
    v = rng.integers(0, 1000, n).astype(np.int64)
    nullable_vals = rng.integers(0, 50, n).astype(np.int64)
    null_mask = rng.random(n) < 0.1
    nv = pa.array(nullable_vals, mask=null_mask)
    table = pa.table({"s": s, "b": b, "v": pa.array(v), "nv": nv})
    path = str(tmp_path / "dist_str.str")
    write_file(
        path,
        table,
        options=WriteOptions(
            default_compression=Compression.LZ4, max_page_size=256
        ),
    )
    dt = distributed_scan(path, mesh)
    valid = np.asarray(dt["__valid__"].values)
    # string codes decode through the global dictionary to the source rows
    codes = np.asarray(dt["s"].values)[valid]
    gdict = dt["s"].dictionary
    decoded = np.array(
        [gdict[int(c)].as_py() for c in codes[:50]], dtype=object
    )
    src = np.array([cats[i] for i in sidx], dtype=object)
    # rows keep page order within shards; compare the full multiset per value
    import collections

    got_counts = collections.Counter(
        gdict[int(c)].as_py() for c in codes
    )
    exp_counts = collections.Counter(src.tolist())
    assert got_counts == exp_counts
    # boolean column survives
    bb = np.asarray(dt["b"].values)[valid]
    assert bb.sum() == np.asarray(table["b"]).sum()
    # nullable validity carried
    nvv = np.asarray(dt["nv"].validity)[valid]
    assert nvv.sum() == (~null_mask).sum()
    del decoded


def test_distributed_q1_utf8_keys(mesh, tmp_path):
    """Distributed TPC-H Q1 shape: utf8 group keys (returnflag, linestatus),
    8 aggregates, vs a numpy reference — the flagship config-5 workload."""
    import pyarrow as pa

    from strawboat.api import write_file
    from strawboat.codecs import WriteOptions
    from strawboat.constants import Compression
    from strawboat.parallel.dist_scan import distributed_scan

    rng = np.random.default_rng(11)
    n = 8 * 800
    rf = np.array(["A", "N", "R"])[rng.integers(0, 3, n)]
    ls = np.array(["F", "O"])[rng.integers(0, 2, n)]
    qty = rng.integers(1, 51, n).astype(np.int64)
    price = rng.integers(100, 10**5, n).astype(np.int64)  # cents
    disc = rng.integers(0, 11, n).astype(np.int64)  # percent
    table = pa.table(
        {
            "rf": pa.array(rf.tolist()),
            "ls": pa.array(ls.tolist()),
            "qty": pa.array(qty),
            "price": pa.array(price),
            "disc": pa.array(disc),
        }
    )
    path = str(tmp_path / "q1.str")
    write_file(
        path,
        table,
        options=WriteOptions(
            default_compression=Compression.LZ4, max_page_size=400
        ),
    )
    dt = distributed_scan(path, mesh)
    rf_codes = dt["rf"].values.astype(jnp.int64)
    ls_codes = dt["ls"].values.astype(jnp.int64)
    n_ls = len(dt["ls"].dictionary)
    combined = rf_codes * n_ls + ls_codes  # exact composite (no hash mix)
    disc_price = dt["price"].values * (100 - dt["disc"].values)  # ×100 scale
    res = distributed_aggregate(
        mesh,
        "shards",
        combined,
        {
            "sum_qty": ("sum", dt["qty"].values),
            "sum_price": ("sum", dt["price"].values),
            "sum_disc_price": ("sum", disc_price),
            "sum_disc": ("sum", dt["disc"].values),
            "min_qty": ("min", dt["qty"].values),
            "max_qty": ("max", dt["qty"].values),
            "cnt": ("count", dt["qty"].values),
            "max_price": ("max", dt["price"].values),
        },
        mask=dt["__valid__"].values,
        num_groups=64,
    )
    rf_dict = [x.as_py() for x in dt["rf"].dictionary.cast(pa.large_binary())]
    ls_dict = [x.as_py() for x in dt["ls"].dictionary.cast(pa.large_binary())]
    got = {}
    ok = np.asarray(res["valid"])
    keys = np.asarray(res["keys"])
    for i in np.flatnonzero(ok):
        kk = int(keys[i])
        name = (rf_dict[kk // n_ls].decode(), ls_dict[kk % n_ls].decode())
        got[name] = (
            int(np.asarray(res["sum_qty"])[i]),
            int(np.asarray(res["sum_price"])[i]),
            int(np.asarray(res["sum_disc_price"])[i]),
            int(np.asarray(res["sum_disc"])[i]),
            int(np.asarray(res["min_qty"])[i]),
            int(np.asarray(res["max_qty"])[i]),
            int(np.asarray(res["cnt"])[i]),
            int(np.asarray(res["max_price"])[i]),
        )
    exp = {}
    for g_rf in np.unique(rf):
        for g_ls in np.unique(ls):
            sel = (rf == g_rf) & (ls == g_ls)
            if not sel.any():
                continue
            exp[(g_rf, g_ls)] = (
                int(qty[sel].sum()),
                int(price[sel].sum()),
                int((price[sel] * (100 - disc[sel])).sum()),
                int(disc[sel].sum()),
                int(qty[sel].min()),
                int(qty[sel].max()),
                int(sel.sum()),
                int(price[sel].max()),
            )
    assert got == exp


def test_local_shard_table_covers_file(tmp_path):
    """Per-process byte-range reads: the union of every process's local
    shard equals the file; no process decodes outside its range."""
    import pyarrow as pa

    from strawboat.api import write_file
    from strawboat.codecs import WriteOptions
    from strawboat.constants import Compression
    from strawboat.parallel.dist_scan import (
        _merge_dictionaries,
        local_shard_table,
    )

    rng = np.random.default_rng(3)
    n = 4 * 700
    s = np.array(["x", "y", "z"])[rng.integers(0, 3, n)]
    v = rng.integers(0, 99, n).astype(np.int64)
    table = pa.table({"s": pa.array(s.tolist()), "v": pa.array(v)})
    path = str(tmp_path / "shards.str")
    write_file(
        path,
        table,
        options=WriteOptions(
            default_compression=Compression.LZ4, max_page_size=350
        ),
    )
    P = 4
    vals = []
    texts = []
    dicts = []
    shard_codes = []
    for p in range(P):
        t, local_dicts = local_shard_table(path, p, P)
        vals.append(np.asarray(t["v"].values))
        dicts.append(local_dicts["s"])
        shard_codes.append(np.asarray(t["s"].values))
    np.testing.assert_array_equal(np.concatenate(vals), v)
    gdict, tables = _merge_dictionaries(dicts)
    for p in range(P):
        texts.append(
            np.array(
                [gdict[int(c)].as_py() for c in tables[p][shard_codes[p]]],
                dtype=object,
            )
        )
    got = np.concatenate(texts)
    np.testing.assert_array_equal(
        got, np.array([x.encode() for x in s], dtype=object)
    )


def test_distributed_scan_dataset(tmp_path):
    """Multi-file sharded scan: units balance across shards, global dict,
    full distributed aggregate agrees with numpy over the whole dataset."""
    import jax
    import jax.numpy as jnp
    import pyarrow as pa

    from strawboat.api import write_file
    from strawboat.codecs import WriteOptions
    from strawboat.constants import Compression
    from strawboat.parallel import (
        distributed_aggregate,
        distributed_scan_dataset,
        make_mesh,
    )

    mesh = make_mesh(8)
    paths = []
    ks, vs, ss = [], [], []
    rows = [96, 224, 64]  # uneven: forces the greedy balance
    for i, n in enumerate(rows):
        rng = np.random.default_rng(i + 1)
        k = rng.integers(0, 5, n).astype(np.int64)
        v = rng.integers(0, 1000, n).astype(np.int64)
        s = np.array([f"f{i}", "shared"])[rng.integers(0, 2, n)]
        t = pa.table(
            {"k": pa.array(k), "v": pa.array(v), "s": pa.array(s.tolist())}
        )
        p = str(tmp_path / f"part-{i}.str")
        write_file(
            p,
            t,
            options=WriteOptions(
                default_compression=Compression.LZ4, max_page_size=32
            ),
        )
        paths.append(p)
        ks.append(k), vs.append(v), ss.append(s)
    k = np.concatenate(ks)
    v = np.concatenate(vs)
    s = np.concatenate(ss)

    dt = distributed_scan_dataset(paths, mesh)
    valid = np.asarray(dt["__valid__"].values)
    assert int(valid.sum()) == sum(rows)
    # numeric content (order within shards is an implementation detail —
    # compare as multisets and by keyed totals)
    got_v = np.sort(np.asarray(dt["v"].values)[valid])
    np.testing.assert_array_equal(got_v, np.sort(v))

    res = distributed_aggregate(
        mesh,
        "shards",
        dt["k"].values,
        {"total": ("sum", dt["v"].values)},
        mask=dt["__valid__"].values,
        num_groups=32,
    )
    ok = np.asarray(res["valid"])
    got = dict(
        zip(
            np.asarray(res["keys"])[ok].tolist(),
            np.asarray(res["total"])[ok].tolist(),
        )
    )
    exp = {int(g): int(v[k == g].sum()) for g in np.unique(k)}
    assert got == exp

    # utf8 keys through the global dictionary
    res2 = distributed_aggregate(
        mesh,
        "shards",
        dt["s"].values.astype(jnp.int64),
        {"cnt": ("count", dt["v"].values)},
        mask=dt["__valid__"].values,
        num_groups=32,
    )
    ok2 = np.asarray(res2["valid"])
    d = dt["s"].dictionary
    got2 = {}
    for code, cnt in zip(
        np.asarray(res2["keys"])[ok2], np.asarray(res2["cnt"])[ok2]
    ):
        key = d[int(code)].as_py()
        key = key.decode() if isinstance(key, bytes) else key
        got2[key] = int(cnt)
    import collections

    exp2 = dict(collections.Counter(s.tolist()))
    assert got2 == exp2


def test_streamed_dataset_aggregate(tmp_path):
    """Streaming dataset -> pipelined distributed aggregate == numpy, with
    file-level pruning engaged (one part proven irrelevant by its zones)."""
    import pyarrow as pa

    from strawboat.api import write_file
    from strawboat.codecs import WriteOptions
    from strawboat.constants import Compression
    from strawboat.exec.pruning import Comparison
    from strawboat.parallel import make_mesh
    from strawboat.parallel.pipeline import streamed_dataset_aggregate

    mesh = make_mesh(8)
    opts = WriteOptions(
        default_compression=Compression.LZ4, max_page_size=64, zone_maps=True
    )
    paths, gs, vs, ds = [], [], [], []
    for i in range(3):
        rng = np.random.default_rng(10 + i)
        n = 300 + 40 * i
        g = rng.integers(0, 7, n).astype(np.int64)
        v = rng.integers(0, 1000, n).astype(np.int64)
        dt_col = np.full(n, i * 100, dtype=np.int64)  # per-file date band
        t = pa.table(
            {"g": pa.array(g), "v": pa.array(v), "d": pa.array(dt_col)}
        )
        p = str(tmp_path / f"s-{i}.str")
        write_file(p, t, options=opts)
        paths.append(p), gs.append(g), vs.append(v), ds.append(dt_col)

    preds = [Comparison("d", "lt", 150)]  # drops file 2 footer-only
    res = streamed_dataset_aggregate(
        mesh,
        "shards",
        paths,
        key="g",
        aggs={"total": ("sum", "v"), "cnt": ("count", "v")},
        chunk_pages=2,
        num_groups=64,
        predicates=preds,
    )
    ok = np.asarray(res["valid"])
    got = dict(
        zip(
            np.asarray(res["keys"])[ok].tolist(),
            np.asarray(res["total"])[ok].tolist(),
        )
    )
    g = np.concatenate(gs[:2])
    v = np.concatenate(vs[:2])
    exp = {int(x): int(v[g == x].sum()) for x in np.unique(g)}
    assert got == exp
