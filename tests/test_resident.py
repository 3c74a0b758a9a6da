"""Compressed-in-HBM resident tables: tiled-order queries == natural truth.

Round 4: the loader decodes through the complete host read path and
re-encodes into packed planes, so EVERY page codec / type / nullability the
format produces must load (the former narrow-slice raises are gone), and
the Query DSL runs over resident sources.

The plane unpack is plain jnp, so these run as they are on the CPU
(conftest forces it); ``chip_smoke.py`` runs the same path on the GPU.
"""

from unittest import mock

import numpy as np
import pyarrow as pa
import pytest

from strawboat.api import write_file
from strawboat.codecs import WriteOptions
from strawboat.constants import Compression
from strawboat.errors import NotYetImplementedError


def _write(tmp_path, n=2048, seed=0):
    rng = np.random.default_rng(seed)
    sd = rng.integers(0, 2557, n).astype(np.int32)
    qty = rng.integers(1, 51, n).astype(np.int32)
    disc = rng.integers(0, 11, n).astype(np.int32)
    ep = rng.integers(0, 60000, n).astype(np.int32)
    grp = rng.integers(0, 6, n).astype(np.int32)
    fields = [
        pa.field(nm, pa.int32(), nullable=False)
        for nm in ("sd", "qty", "disc", "ep", "grp")
    ]
    t = pa.table(
        dict(zip(["sd", "qty", "disc", "ep", "grp"], map(pa.array, (sd, qty, disc, ep, grp)))),
        schema=pa.schema(fields),
    )
    p = str(tmp_path / "res.str")
    write_file(
        p,
        t,
        options=WriteOptions(
            default_compression=Compression.LZ4,
            default_compress_ratio=1.0,
            max_page_size=512,
        ),
    )
    return p, dict(sd=sd, qty=qty, disc=disc, ep=ep, grp=grp)


def test_resident_filter_sum_q6_shape(tmp_path):
    from strawboat.exec.resident import load_resident

    p, cols = _write(tmp_path)
    rt = load_resident(p, tile=512)
    assert rt.num_rows == 2048
    got = int(
        rt.filter_sum(
            {"sd": (731, 1096), "disc": (5, 8), "qty": (None, 24)},
            value="ep",
            product_with="disc",
        )
    )
    m = (
        (cols["sd"] >= 731)
        & (cols["sd"] < 1096)
        & (cols["disc"] >= 5)
        & (cols["disc"] < 8)
        & (cols["qty"] < 24)
    )
    exp = int((cols["ep"][m].astype(np.int64) * cols["disc"][m]).sum())
    assert got == exp


def test_resident_group_sum(tmp_path):
    from strawboat.exec.resident import load_resident

    p, cols = _write(tmp_path, seed=1)
    rt = load_resident(p, tile=512)
    (sums,), cnt = rt.group_sum("grp", ["ep"], num_groups=6)
    sums = np.asarray(sums)
    cnt = np.asarray(cnt)
    for g in range(6):
        sel = cols["grp"] == g
        assert sums[g] == int(cols["ep"][sel].astype(np.int64).sum())
        assert cnt[g] == int(sel.sum())


def test_resident_partial_tail_page(tmp_path):
    """Row count not a multiple of the page/tile grid: padding masked out."""
    from strawboat.exec.resident import load_resident

    n = 2048 - 333
    rng = np.random.default_rng(3)
    v = rng.integers(0, 1000, n).astype(np.int32)
    t = pa.table(
        {"v": pa.array(v)},
        schema=pa.schema([pa.field("v", pa.int32(), nullable=False)]),
    )
    p = str(tmp_path / "tail.str")
    write_file(
        p,
        t,
        options=WriteOptions(
            default_compression=Compression.LZ4,
            default_compress_ratio=1.0,
            max_page_size=512,
        ),
    )
    rt = load_resident(p, tile=512)
    assert rt.num_rows == n
    got = int(rt.filter_sum({}, value="v"))
    assert got == int(v.astype(np.int64).sum())


# ---------------------------------------------------------------------------
# Round 4: full-format coverage (wide/negative ints, floats, nullable, bool,
# strings, every page codec the chooser emits) + Query DSL + resident join.
# ---------------------------------------------------------------------------


def _roundtrip(tmp_path, table: pa.Table, name="rt.str", page=512, ratio=None):
    from strawboat.exec.resident import load_resident

    p = str(tmp_path / name)
    write_file(
        p,
        table,
        options=WriteOptions(
            default_compression=Compression.LZ4,
            default_compress_ratio=ratio,
            max_page_size=page,
        ),
    )
    rt = load_resident(p, tile=512)
    back = rt.to_arrow()
    assert back.num_rows == table.num_rows
    for f in table.schema:
        exp = table.column(f.name).combine_chunks()
        got = back.column(f.name).combine_chunks()
        if got.type != exp.type:
            got = got.cast(exp.type)
        if pa.types.is_floating(exp.type):
            # bit-level comparison (stronger than equals, and NaN-proof)
            assert _float_bits_equal(exp, got), f"column {f.name!r} bits"
        else:
            assert got.equals(exp), f"column {f.name!r} roundtrip mismatch"
    return rt


def _float_bits_equal(exp: pa.Array, got: pa.Array) -> bool:
    ok_e = ~np.asarray(exp.is_null())
    ok_g = ~np.asarray(got.is_null())
    if not np.array_equal(ok_e, ok_g):
        return False
    npdt = np.float32 if exp.type.bit_width == 32 else np.float64
    udt = np.uint32 if exp.type.bit_width == 32 else np.uint64

    def bits(a):
        return np.frombuffer(
            a.buffers()[1], dtype=npdt, count=len(a) + a.offset
        )[a.offset :].view(udt)

    return np.array_equal(bits(exp)[ok_e], bits(got)[ok_g])


def test_resident_wide_int64_loads_and_sums(tmp_path):
    # previously raised: wide int64 (LZ4 raw pages, values >= 2^31)
    rng = np.random.default_rng(0)
    v = rng.integers(0, 1 << 60, 512)
    t = pa.table(
        {"w": pa.array(v)},
        schema=pa.schema([pa.field("w", pa.int64(), nullable=False)]),
    )
    rt = _roundtrip(tmp_path, t, "wide.str")
    assert int(rt.filter_sum({}, value="w")) == int(v.sum())
    lo, hi = int(np.quantile(v, 0.3)), int(np.quantile(v, 0.8))
    got = int(rt.filter_sum({"w": (lo, hi)}, value="w"))
    sel = (v >= lo) & (v < hi)
    assert got == int(v[sel].sum())


def test_resident_negative_ints(tmp_path):
    rng = np.random.default_rng(7)
    v = rng.integers(-5000, 5000, 700)
    t = pa.table(
        {"n": pa.array(v)},
        schema=pa.schema([pa.field("n", pa.int64(), nullable=False)]),
    )
    rt = _roundtrip(tmp_path, t, "neg.str")
    got = int(rt.filter_sum({"n": (-1000, 1000)}, value="n"))
    sel = (v >= -1000) & (v < 1000)
    assert got == int(v[sel].sum())


def test_resident_int64_extremes(tmp_path):
    v = np.array(
        [np.iinfo(np.int64).min, -1, 0, 1, np.iinfo(np.int64).max] * 40,
        dtype=np.int64,
    )
    t = pa.table(
        {"x": pa.array(v)},
        schema=pa.schema([pa.field("x", pa.int64(), nullable=False)]),
    )
    rt = _roundtrip(tmp_path, t, "ext.str")
    got = int(rt.filter_sum({"x": (0, None)}, value="x"))
    assert got == int(v[v >= 0].sum())


def test_resident_floats(tmp_path):
    rng = np.random.default_rng(5)
    f64 = np.round(rng.uniform(900.0, 105000.0, 800), 2)
    f32 = rng.standard_normal(800).astype(np.float32)
    t = pa.table(
        {"p": pa.array(f64), "g": pa.array(f32)},
        schema=pa.schema(
            [
                pa.field("p", pa.float64(), nullable=False),
                pa.field("g", pa.float32(), nullable=False),
            ]
        ),
    )
    rt = _roundtrip(tmp_path, t, "flt.str")
    got = float(rt.filter_sum({"p": (1000.0, 50000.0)}, value="p"))
    sel = (f64 >= 1000.0) & (f64 < 50000.0)
    assert got == pytest.approx(float(f64[sel].sum()), rel=1e-12)


def test_resident_nullable_with_nulls(tmp_path):
    rng = np.random.default_rng(11)
    v = rng.integers(0, 100, 600)
    nulls = rng.random(600) < 0.25
    arr = pa.array(np.where(nulls, 0, v), mask=nulls)
    t = pa.table(
        {"v": arr},
        schema=pa.schema([pa.field("v", pa.int64(), nullable=True)]),
    )
    rt = _roundtrip(tmp_path, t, "nul.str")
    # null rows never count in filter_sum
    got = int(rt.filter_sum({"v": (10, 90)}, value="v"))
    sel = ~nulls & (v >= 10) & (v < 90)
    assert got == int(v[sel].sum())


def test_resident_bool_column(tmp_path):
    rng = np.random.default_rng(2)
    b = rng.random(500) < 0.5
    v = rng.integers(0, 10, 500)
    t = pa.table(
        {"b": pa.array(b), "v": pa.array(v)},
        schema=pa.schema(
            [
                pa.field("b", pa.bool_(), nullable=False),
                pa.field("v", pa.int64(), nullable=False),
            ]
        ),
    )
    _roundtrip(tmp_path, t, "bool.str")


def test_resident_codec_matrix(tmp_path):
    """Shapes that drive the chooser into each page codec all load exactly."""
    n = 1024
    rng = np.random.default_rng(9)
    cols = {
        "dicty": rng.integers(0, 4, n) * 1_000_003,        # DICT
        "freqy": np.where(rng.random(n) < 0.95, 7, rng.integers(0, 1000, n)),  # FREQ
        "rley": np.repeat(rng.integers(0, 50, n // 64), 64),  # RLE
        "sorted": np.sort(rng.integers(0, 1 << 40, n)),       # DeltaBP
        "one": np.full(n, 42),                                # OneValue
        "bp": rng.integers(0, 1 << 12, n),                    # Bitpacking
        "rawish": rng.integers(-(1 << 62), 1 << 62, n),       # raw/LZ4
    }
    t = pa.table(
        {k: pa.array(v) for k, v in cols.items()},
        schema=pa.schema(
            [pa.field(k, pa.int64(), nullable=False) for k in cols]
        ),
    )
    rt = _roundtrip(tmp_path, t, "codecs.str", page=256)
    for k, v in cols.items():
        assert int(rt.filter_sum({}, value=k)) == int(v.sum()), k


def test_resident_strings_and_dsl(tmp_path):
    from strawboat.exec.query import Query
    from strawboat.exec.expr import col
    from strawboat.exec.resident import load_resident

    rng = np.random.default_rng(4)
    n = 1200
    flags = np.array(["A", "N", "R"])[rng.integers(0, 3, n)]
    status = np.array(["F", "O"])[rng.integers(0, 2, n)]
    qty = rng.integers(1, 51, n)
    price = np.round(rng.uniform(900.0, 105000.0, n), 2)
    t = pa.table(
        {
            "flag": pa.array(flags),
            "status": pa.array(status),
            "qty": pa.array(qty),
            "price": pa.array(price),
        },
        schema=pa.schema(
            [
                pa.field("flag", pa.string(), nullable=False),
                pa.field("status", pa.string(), nullable=False),
                pa.field("qty", pa.int64(), nullable=False),
                pa.field("price", pa.float64(), nullable=False),
            ]
        ),
    )
    rt = _roundtrip(tmp_path, t, "str.str")
    # Q1 shape through the DSL over the RESIDENT source
    res = (
        Query(rt)
        .filter(col("qty") < 40)
        .group_by("flag", "status", num_groups=16)
        .agg(
            sum_qty=("sum", "qty"),
            avg_price=("avg", "price"),
            n=("count", "qty"),
        )
        .run()
    )
    ng = int(res["n_groups"])
    got = {}
    for i in range(ng):
        fcode = int(res["key_flag"][i])
        scode = int(res["key_status"][i])
        f = res["dict_flag"][fcode].as_py()
        s = res["dict_status"][scode].as_py()
        got[(f, s)] = (
            int(res["sum_qty"][i]),
            float(res["avg_price"][i]),
            int(res["n"][i]),
        )
    sel = qty < 40
    exp_groups = {}
    for f in "ANR":
        for s in "FO":
            m = sel & (flags == f) & (status == s)
            if m.any():
                exp_groups[(f, s)] = (
                    int(qty[m].sum()),
                    float(price[m].mean()),
                    int(m.sum()),
                )
    assert set(got) == set(exp_groups)
    for k in exp_groups:
        assert got[k][0] == exp_groups[k][0], k
        assert got[k][2] == exp_groups[k][2], k
        assert got[k][1] == pytest.approx(exp_groups[k][1], rel=1e-9)
    # string-literal predicate over the resident dictionary column
    res2 = (
        Query(rt)
        .filter(col("flag") == "A")
        .agg(s=("sum", "qty"))
        .run()
    )
    assert int(res2["s"]) == int(qty[flags == "A"].sum())


def test_resident_query_limit_natural_order(tmp_path):
    """LIMIT over a resident source returns FILE-order rows, not tiled."""
    from strawboat.exec.query import Query

    n = 700
    v = np.arange(n, dtype=np.int64) * 3
    t = pa.table(
        {"v": pa.array(v)},
        schema=pa.schema([pa.field("v", pa.int64(), nullable=False)]),
    )
    rt = _roundtrip(tmp_path, t, "lim.str")
    out, _mask = Query(rt).limit(5).run()
    got = np.asarray(out["v"].values)
    assert got.tolist() == v[:5].tolist()


def test_resident_join_through_dsl(tmp_path):
    """Resident probe side joined against a small file build side."""
    from strawboat.exec.query import Query
    from strawboat.exec.expr import col

    rng = np.random.default_rng(12)
    n = 900
    key = rng.integers(0, 50, n)
    val = rng.integers(0, 1000, n)
    probe = pa.table(
        {"k": pa.array(key), "v": pa.array(val)},
        schema=pa.schema(
            [
                pa.field("k", pa.int64(), nullable=False),
                pa.field("v", pa.int64(), nullable=False),
            ]
        ),
    )
    rt = _roundtrip(tmp_path, probe, "probe.str")
    bkey = np.arange(50, dtype=np.int64)
    bval = (bkey * 7 + 1).astype(np.int64)
    build = pa.table(
        {"bk": pa.array(bkey), "bonus": pa.array(bval)},
        schema=pa.schema(
            [
                pa.field("bk", pa.int64(), nullable=False),
                pa.field("bonus", pa.int64(), nullable=False),
            ]
        ),
    )
    bpath = str(tmp_path / "build.str")
    write_file(bpath, build, options=WriteOptions(max_page_size=64))
    res = (
        Query(rt)
        .join(bpath, on=("k", "bk"))
        .filter(col("bonus") > 100)
        .agg(s=("sum", "v"))
        .run()
    )
    bonus_of = bval[key]
    sel = bonus_of > 100
    assert int(res["s"]) == int(val[sel].sum())


def test_resident_unsupported_types_raise(tmp_path):
    # lists/structs/maps load since r5; a decimal wider than the unscaled
    # int64 domain stays an explicit raise (never silent)
    import decimal

    from strawboat.exec.resident import load_resident

    dt = pa.decimal128(25, 2)
    t = pa.table(
        {"d": pa.array([decimal.Decimal("12345678901234567890.12")] * 8, dt)},
        schema=pa.schema([pa.field("d", dt, nullable=False)]),
    )
    p = str(tmp_path / "widedec.str")
    write_file(p, t)
    with pytest.raises(NotYetImplementedError):
        load_resident(p)


def test_resident_map_and_list_struct(tmp_path):
    """map<utf8, int64> and list<struct<...>> load (lengths plane + struct
    child over the entry grid) and round-trip exactly."""
    mt = pa.map_(pa.string(), pa.int64())
    maps = [[("a", 1)], None, [("b", 2), ("c", 3)], [], [("d", 4)]] * 60
    lt = pa.list_(pa.struct([("x", pa.int64()), ("y", pa.string())]))
    lists = [
        [{"x": 1, "y": "p"}],
        [],
        [{"x": 2, "y": "q"}, {"x": 3, "y": "r"}],
        None,
    ] * 75
    t = pa.table(
        {
            "m": pa.array(maps, mt),
            "ls": pa.array(lists, lt),
        },
        schema=pa.schema(
            [
                pa.field("m", mt, nullable=True),
                pa.field("ls", lt, nullable=True),
            ]
        ),
    )
    _roundtrip(tmp_path, t, "maplist.str")


def test_resident_decode_natural_matches(tmp_path):
    from strawboat.exec.resident import load_resident

    p, cols = _write(tmp_path, seed=8)
    rt = load_resident(p, tile=512)
    nat = np.asarray(rt.decode_natural("ep"))
    assert nat.tolist() == cols["ep"].tolist()


def test_resident_decimal128(tmp_path):
    """decimal128 (precision <= 18) loads as unscaled-int64 planes and
    round-trips exactly; predicates compare unscaled ints (the scan-layer
    convention)."""
    import decimal

    from strawboat.exec.resident import load_resident

    vals = [decimal.Decimal(f"{x}.{x % 100:02d}") for x in range(300)]
    t = pa.table(
        {"d": pa.array(vals, pa.decimal128(12, 2))},
        schema=pa.schema([pa.field("d", pa.decimal128(12, 2), nullable=False)]),
    )
    rt = _roundtrip(tmp_path, t, "dec.str")
    # unscaled sum: value x.y has unscaled 100x + y
    unscaled = np.array([int(v.scaleb(2)) for v in vals], dtype=np.int64)
    got = int(rt.filter_sum({"d": (int(unscaled[100]), None)}, value="d"))
    assert got == int(unscaled[unscaled >= unscaled[100]].sum())


def test_resident_multifile_dataset(tmp_path):
    from strawboat.exec.dataset import write_dataset
    from strawboat.exec.resident import load_resident

    rng = np.random.default_rng(6)
    n = 1500
    v = rng.integers(0, 500, n)
    g = rng.integers(0, 4, n)
    t = pa.table(
        {"v": pa.array(v), "g": pa.array(g)},
        schema=pa.schema(
            [
                pa.field("v", pa.int64(), nullable=False),
                pa.field("g", pa.int64(), nullable=False),
            ]
        ),
    )
    d = tmp_path / "ds"
    write_dataset(str(d), t, rows_per_file=400)
    rt = load_resident(str(d / "part-*.str"), tile=512)
    assert rt.num_rows == n
    (sums,), cnt = rt.group_sum("g", ["v"], num_groups=4)
    for k in range(4):
        sel = g == k
        assert int(np.asarray(sums)[k]) == int(v[sel].sum())
        assert int(np.asarray(cnt)[k]) == int(sel.sum())


def test_make_resident_from_device_table(tmp_path):
    """scan → (query stack) → make_resident: the serving handoff without a
    file roundtrip."""
    from strawboat.exec import scan_file
    from strawboat.exec.resident import make_resident

    p, cols = _write(tmp_path, seed=9)
    dt = scan_file(p)
    rt = make_resident(dt, tile=512)
    assert rt.num_rows == 2048
    got = int(rt.filter_sum({"sd": (500, 1500)}, value="ep"))
    sel = (cols["sd"] >= 500) & (cols["sd"] < 1500)
    assert got == int(cols["ep"][sel].astype(np.int64).sum())


def test_resident_int64_semantics_no_int32_wrap(tmp_path):
    """An int64 column with narrow values must DECODE as int64 (scan-path
    dtype), so per-row expression products and sums never wrap in int32 —
    the resident-Q1-on-chip bug."""
    from strawboat.exec.query import Query
    from strawboat.exec.expr import col

    n = 600
    rng = np.random.default_rng(13)
    price = rng.integers(10_000_000, 99_000_000, n)  # fits int32 barely
    mult = rng.integers(90, 111, n)
    t = pa.table(
        {"price": pa.array(price), "mult": pa.array(mult)},
        schema=pa.schema(
            [
                pa.field("price", pa.int64(), nullable=False),
                pa.field("mult", pa.int64(), nullable=False),
            ]
        ),
    )
    rt = _roundtrip(tmp_path, t, "wrap.str")
    assert str(rt["price"].decoded_dtype()) == "int64"
    res = (
        Query(rt)
        .agg(s=("sum", col("price") * col("mult")))  # per-row > 2^31
        .run()
    )
    assert int(res["s"]) == int((price * mult).sum())
    # plain sum of the column itself also exceeds int32
    res2 = Query(rt).agg(s=("sum", "price")).run()
    assert int(res2["s"]) == int(price.sum())


def test_resident_fused_group_order_minmax(tmp_path):
    """Fused resident grouped path: min/max/avg aggregates, numeric dict
    keys, ORDER BY ... LIMIT."""
    from strawboat.exec.query import Query
    from strawboat.exec.expr import col

    rng = np.random.default_rng(21)
    n = 1000
    g = rng.integers(0, 5, n) * 111  # numeric dict key (low cardinality)
    v = rng.integers(-500, 500, n)
    t = pa.table(
        {"g": pa.array(g), "v": pa.array(v)},
        schema=pa.schema(
            [
                pa.field("g", pa.int64(), nullable=False),
                pa.field("v", pa.int64(), nullable=False),
            ]
        ),
    )
    rt = _roundtrip(tmp_path, t, "fgrp.str")
    q = (
        Query(rt)
        .filter(col("v") > -400)
        .group_by("g", num_groups=16)
        .agg(
            mn=("min", "v"), mx=("max", "v"), s=("sum", "v"),
            a=("avg", "v"), c=("count", "v"),
        )
        .order_by(("s", "desc"))
        .limit(3)
    )
    res = q.run()
    res2 = q.run()  # memoized fused impl: second call must agree
    sel = v > -400
    exp = {}
    for k in np.unique(g):
        m = sel & (g == k)
        if m.any():
            exp[int(k)] = (
                int(v[m].min()), int(v[m].max()), int(v[m].sum()),
                float(v[m].mean()), int(m.sum()),
            )
    top = sorted(exp.items(), key=lambda kv: -kv[1][2])[:3]
    assert int(res["n_groups"]) == 3
    for i, (k, e) in enumerate(top):
        assert int(res["key_g"][i]) == k
        assert (int(res["mn"][i]), int(res["mx"][i]), int(res["s"][i])) == e[:3]
        assert float(res["a"][i]) == pytest.approx(e[3])
        assert int(res["c"][i]) == e[4]
        assert int(res2["s"][i]) == e[2]


@pytest.mark.parametrize("seed", [0, 1, 2, 3, 4, 5])
def test_resident_fuzz_roundtrip(tmp_path, seed):
    """Random schema/dtype/nullability/cardinality tables roundtrip through
    resident planes exactly (floats compared at the BIT level, so NaN/inf
    injection is covered); a random range filter_sum AND a random grouped
    aggregate match numpy.  Seeds 4–5 cross the default 65,536-row page
    boundary with the default page size."""
    rng = np.random.default_rng(100 + seed)
    big = seed >= 4
    n = int(rng.integers(66_000, 80_000)) if big else int(rng.integers(300, 1500))
    cols = {}
    schema = []
    kinds = list(
        rng.choice(
            ["i64", "i32", "i64wide", "f64", "f32", "str", "bool", "neg",
             "ts", "date", "dec", "allnull", "f64nan"],
            size=3 if big else 5,
            replace=True,
        )
    )
    kinds.append("grp")  # always one groupable small-cardinality key
    for i, kind in enumerate(kinds):
        name = f"c{i}_{kind}"
        nullable = bool(rng.random() < 0.4)
        nulls = rng.random(n) < 0.2 if nullable else None
        if kind == "i64":
            v = rng.integers(0, 10 ** int(rng.integers(1, 9)), n)
            arr = pa.array(v, pa.int64())
            ptype = pa.int64()
        elif kind == "i32":
            v = rng.integers(0, 1 << 20, n).astype(np.int32)
            arr = pa.array(v, pa.int32())
            ptype = pa.int32()
        elif kind == "i64wide":
            v = rng.integers(-(1 << 62), 1 << 62, n)
            arr = pa.array(v, pa.int64())
            ptype = pa.int64()
        elif kind == "neg":
            v = rng.integers(-10000, 100, n)
            arr = pa.array(v, pa.int64())
            ptype = pa.int64()
        elif kind == "grp":
            v = rng.integers(0, 9, n)
            arr = pa.array(v, pa.int64())
            ptype = pa.int64()
            nullable, nulls = False, None  # the grouped-agg key stays dense
        elif kind == "f64":
            v = np.round(rng.uniform(-1000, 1000, n), int(rng.integers(0, 4)))
            arr = pa.array(v, pa.float64())
            ptype = pa.float64()
        elif kind == "f64nan":
            v = rng.uniform(-10, 10, n)
            sp = rng.integers(0, 5, n)
            v[sp == 0] = np.nan
            v[sp == 1] = np.inf
            v[sp == 2] = -np.inf
            v[sp == 3] = -0.0
            arr = pa.array(v, pa.float64())
            ptype = pa.float64()
        elif kind == "f32":
            v = rng.standard_normal(n).astype(np.float32)
            arr = pa.array(v, pa.float32())
            ptype = pa.float32()
        elif kind == "bool":
            v = rng.random(n) < 0.5
            arr = pa.array(v, pa.bool_())
            ptype = pa.bool_()
        elif kind == "ts":
            v = rng.integers(1_500_000_000_000_000, 1_800_000_000_000_000, n)
            ptype = pa.timestamp("us")
            arr = pa.array(v, pa.int64()).cast(ptype)
        elif kind == "date":
            v = rng.integers(10_000, 20_000, n).astype(np.int32)
            ptype = pa.date32()
            arr = pa.array(v, pa.int32()).cast(ptype)
        elif kind == "dec":
            import decimal

            ptype = pa.decimal128(12, 2)
            v = rng.integers(-(10**9), 10**9, n)
            arr = pa.array(
                [decimal.Decimal(int(x)) / 100 for x in v], ptype
            )
        elif kind == "allnull":
            ptype = rng.choice([pa.int64(), pa.float64(), pa.string()])
            arr = pa.array([None] * n, ptype)
            nullable, nulls = True, None  # already all null
        else:  # str
            words = np.array(["aa", "bb", "cc", "dd", "ee", "ffff", ""])
            v = words[rng.integers(0, len(words), n)]
            arr = pa.array(v, pa.string())
            ptype = pa.string()
        if nulls is not None:
            arr = pa.array(arr.to_pylist(), ptype, mask=nulls)
        cols[name] = arr
        schema.append(pa.field(name, ptype, nullable=nullable or kind == "allnull"))
    t = pa.table(cols, schema=pa.schema(schema))
    rt = _roundtrip(
        tmp_path, t, f"fuzz{seed}.str", page=65536 if big else 256
    )
    # random filter_sum over the first plain-int column, if any
    for f in t.schema:
        if pa.types.is_integer(f.type):
            src = t.column(f.name).combine_chunks()
            v = np.asarray(src.fill_null(0), dtype=np.int64)
            ok = ~np.asarray(src.is_null())
            lo = int(np.min(v)) if len(v) else 0
            got = int(rt.filter_sum({f.name: (lo, None)}, value=f.name))
            assert got == int(v[ok & (v >= lo)].sum())
            break
    # random grouped aggregate over the dense key vs numpy
    key = next(nm for nm in t.schema.names if nm.endswith("grp"))
    val = next(
        (
            f.name
            for f in t.schema
            if pa.types.is_integer(f.type) and f.name != key
        ),
        key,
    )
    g = np.asarray(t.column(key).combine_chunks())
    src = t.column(val).combine_chunks()
    vv = np.asarray(src.fill_null(0), dtype=np.int64)
    ok = ~np.asarray(src.is_null())
    (sums,), cnt = rt.group_sum(key, [val], num_groups=9)
    sums, cnt = np.asarray(sums), np.asarray(cnt)
    for k in range(9):
        sel = (g == k) & ok
        assert sums[k] == int(vv[sel].sum()), (seed, k)
        assert cnt[k] == int(sel.sum()), (seed, k)


def test_sharded_resident_group_sum(tmp_path):
    """Planes sharded over the 8-device mesh; one psum-combined grouped
    aggregate equals the single-table truth exactly."""
    from strawboat.exec.resident import load_resident
    from strawboat.parallel import make_mesh
    from strawboat.parallel.dist_resident import (
        shard_resident,
        sharded_group_sum,
    )

    p, cols = _write(tmp_path, n=4096, seed=17)
    rt = load_resident(p, tile=512)
    mesh = make_mesh(8)
    srt = shard_resident(rt, mesh, "shards")
    (sums,), cnt = sharded_group_sum(
        srt,
        "grp",
        ["ep"],
        num_groups=6,
        predicates={"sd": (400, 2000)},
    )
    sums = np.asarray(sums)
    cnt = np.asarray(cnt)
    sel = (cols["sd"] >= 400) & (cols["sd"] < 2000)
    for g in range(6):
        mg = sel & (cols["grp"] == g)
        assert sums[g] == int(cols["ep"][mg].astype(np.int64).sum()), g
        assert cnt[g] == int(mg.sum()), g


def test_sharded_resident_filter_sum(tmp_path):
    from strawboat.exec.resident import load_resident
    from strawboat.parallel import make_mesh
    from strawboat.parallel.dist_resident import (
        shard_resident,
        sharded_filter_sum,
    )

    p, cols = _write(tmp_path, n=4096, seed=23)
    rt = load_resident(p, tile=512)
    srt = shard_resident(rt, make_mesh(8), "shards")
    got = int(
        sharded_filter_sum(
            srt,
            {"sd": (731, 1096), "disc": (5, 8), "qty": (None, 24)},
            value="ep",
            product_with="disc",
        )
    )
    m = (
        (cols["sd"] >= 731)
        & (cols["sd"] < 1096)
        & (cols["disc"] >= 5)
        & (cols["disc"] < 8)
        & (cols["qty"] < 24)
    )
    exp = int((cols["ep"][m].astype(np.int64) * cols["disc"][m]).sum())
    assert got == exp


def test_sharded_resident_float_sums(tmp_path):
    """Float value columns in the sharded grouped path (segment-sum branch)."""
    from strawboat.exec.resident import make_resident
    from strawboat.parallel import make_mesh
    from strawboat.parallel.dist_resident import (
        shard_resident,
        sharded_group_sum,
    )

    rng = np.random.default_rng(31)
    n = 2000
    g = rng.integers(0, 4, n)
    f = np.round(rng.uniform(0, 100, n), 2)
    t = pa.table(
        {"g": pa.array(g), "f": pa.array(f)},
        schema=pa.schema(
            [
                pa.field("g", pa.int64(), nullable=False),
                pa.field("f", pa.float64(), nullable=False),
            ]
        ),
    )
    rt = make_resident(t, tile=512)
    srt = shard_resident(rt, make_mesh(8), "shards")
    (sums,), cnt = sharded_group_sum(srt, "g", ["f"], num_groups=4)
    sums, cnt = np.asarray(sums), np.asarray(cnt)
    for k in range(4):
        sel = g == k
        assert sums[k] == pytest.approx(float(f[sel].sum()), rel=1e-12)
        assert cnt[k] == int(sel.sum())


def test_resident_fused_nullable_values(tmp_path):
    """Fused grouped path over a NULLABLE value column: null rows never
    count (validity plane passed as a jit argument, not a baked constant)."""
    from strawboat.exec.query import Query

    rng = np.random.default_rng(41)
    n = 900
    g = np.array(["x", "y", "z"])[rng.integers(0, 3, n)]
    v = rng.integers(0, 1000, n)
    nulls = rng.random(n) < 0.3
    t = pa.table(
        {
            "g": pa.array(g),
            "v": pa.array(np.where(nulls, 0, v), mask=nulls),
        },
        schema=pa.schema(
            [
                pa.field("g", pa.string(), nullable=False),
                pa.field("v", pa.int64(), nullable=True),
            ]
        ),
    )
    rt = _roundtrip(tmp_path, t, "fnul.str")
    res = (
        Query(rt)
        .group_by("g", num_groups=8)
        .agg(s=("sum", "v"), c=("count", "v"))
        .run()
    )
    got = {}
    for i in range(int(res["n_groups"])):
        name = res["dict_g"][int(res["key_g"][i])].as_py()
        got[name] = (int(res["s"][i]), int(res["c"][i]))
    for name in "xyz":
        sel = (g == name) & ~nulls
        # count counts FILTER-surviving rows (mask only); sum skips nulls
        assert got[name][0] == int(v[sel].sum())


def test_resident_fused_scalar_aggs(tmp_path):
    """Ungrouped aggregates over a resident source fuse as a 1-group dense
    pass (the Q6-via-DSL shape)."""
    from strawboat.exec.query import Query
    from strawboat.exec.expr import col

    p, cols = _write(tmp_path, seed=29)
    from strawboat.exec.resident import load_resident

    rt = load_resident(p, tile=512)
    q = (
        Query(rt)
        .filter((col("sd") >= 731) & (col("sd") < 1096) & (col("qty") < 24))
        .agg(
            rev=("sum", col("ep") * col("disc")),
            n=("count", "ep"),
            mx=("max", "ep"),
        )
    )
    res = q.run()
    m = (cols["sd"] >= 731) & (cols["sd"] < 1096) & (cols["qty"] < 24)
    assert int(res["rev"]) == int(
        (cols["ep"][m].astype(np.int64) * cols["disc"][m]).sum()
    )
    assert int(res["n"]) == int(m.sum())
    assert int(res["mx"]) == int(cols["ep"][m].max())
    # empty-selection edge falls back to general-path semantics
    q2 = Query(rt).filter(col("sd") < -1).agg(s=("sum", "ep"), c=("count", "ep"))
    res2 = q2.run()
    assert int(res2["s"]) == 0 and int(res2["c"]) == 0


def test_resident_join_both_sides(tmp_path):
    """Probe AND build sides both resident (padding masks on each side)."""
    from strawboat.exec.query import Query
    from strawboat.exec.resident import make_resident

    rng = np.random.default_rng(51)
    n = 700
    key = rng.integers(0, 40, n)
    val = rng.integers(0, 100, n)
    probe = pa.table(
        {"k": pa.array(key), "v": pa.array(val)},
        schema=pa.schema(
            [
                pa.field("k", pa.int64(), nullable=False),
                pa.field("v", pa.int64(), nullable=False),
            ]
        ),
    )
    bkey = np.arange(40, dtype=np.int64)
    bval = (bkey * 3).astype(np.int64)
    build = pa.table(
        {"bk": pa.array(bkey), "w": pa.array(bval)},
        schema=pa.schema(
            [
                pa.field("bk", pa.int64(), nullable=False),
                pa.field("w", pa.int64(), nullable=False),
            ]
        ),
    )
    rt_p = make_resident(probe, tile=512)
    rt_b = make_resident(build, tile=512)
    res = (
        Query(rt_p)
        .join(Query(rt_b), on=("k", "bk"))
        .agg(s=("sum", "w"))
        .run()
    )
    assert int(res["s"]) == int(bval[key].sum())


def test_resident_nullable_float_preserves_nan_inf(tmp_path):
    """Genuine NaN / ±inf / -0.0 at NON-null positions of a nullable float
    column survive resident load bit-exactly.

    Failing before r5: the loader did ``to_numpy`` + ``nan_to_num`` whenever
    null_count > 0, so a real NaN value in a nullable column silently became
    0.0 with validity=true."""
    from strawboat.exec.resident import load_resident

    specials = [1.5, None, float("nan"), float("inf"), float("-inf"), -0.0,
                0.0, 2.25, None, -1e308]
    vals64 = pa.array(specials * 40, pa.float64())
    with np.errstate(over="ignore"):
        vals32 = pa.array(
            [None if v is None else np.float32(v) for v in specials] * 40,
            pa.float32(),
        )
    t = pa.table(
        {"f64": vals64, "f32": vals32},
        schema=pa.schema(
            [
                pa.field("f64", pa.float64(), nullable=True),
                pa.field("f32", pa.float32(), nullable=True),
            ]
        ),
    )
    p = str(tmp_path / "nanfloat.str")
    write_file(p, t, options=WriteOptions(max_page_size=128))
    rt = load_resident(p, tile=512)
    back = rt.to_arrow()
    for name, npdt, udt in (("f64", np.float64, np.uint64),
                            ("f32", np.float32, np.uint32)):
        exp = t.column(name).combine_chunks()
        got = back.column(name).combine_chunks()
        ok = ~np.asarray(exp.is_null())
        assert np.array_equal(ok, ~np.asarray(got.is_null()))
        eb = np.frombuffer(exp.buffers()[1], dtype=npdt, count=len(exp))
        gb = np.asarray(got.fill_null(0.0), dtype=npdt)
        # bit-exact at every valid position (NaN payloads, inf, -0.0 sign)
        assert np.array_equal(
            eb.view(udt)[ok], gb.view(udt)[ok]
        ), f"{name}: valid float bits changed"


def test_resident_nullable_string_no_cast_warning(tmp_path):
    """Null string indices load through an explicit fill, not a NaN→int64
    cast (r4 emitted 'invalid value encountered in cast' on every nullable
    string load)."""
    import warnings

    from strawboat.exec.resident import load_resident

    arr = pa.array((["aa", None, "bb", "cc", None] * 80), pa.string())
    t = pa.table(
        {"s": arr},
        schema=pa.schema([pa.field("s", pa.string(), nullable=True)]),
    )
    p = str(tmp_path / "nullstr.str")
    write_file(p, t, options=WriteOptions(max_page_size=128))
    with warnings.catch_warnings():
        warnings.simplefilter("error", RuntimeWarning)
        rt = load_resident(p, tile=512)
    back = rt.to_arrow()
    assert back.column("s").combine_chunks().equals(arr)


def test_pack_plane_device_matches_host():
    """The device packer is the bit-level inverse of the unpack kernel and
    must produce EXACTLY the host pack's words for every width class."""
    import jax.numpy as jnp

    from strawboat.exec.resident import _pack_plane, _pack_plane_device

    rng = np.random.default_rng(7)
    for bits in (1, 3, 5, 7, 8, 12, 16, 17, 20, 24, 31, 32):
        n = int(rng.integers(100, 5000))
        vals = rng.integers(0, 1 << bits, n, dtype=np.uint64).astype(np.uint32)
        host = np.asarray(_pack_plane(vals, bits, 512))
        dev = np.asarray(_pack_plane_device(jnp.asarray(vals), bits, 512))
        assert host.shape == dev.shape, bits
        assert np.array_equal(host, dev), f"bits={bits}"


def test_make_resident_device_direct_no_host_roundtrip(tmp_path):
    """make_resident(DeviceTable) builds planes ON DEVICE: no ``to_arrow``
    materialization, no device→host→device round trip), and the result
    round-trips exactly."""
    import pyarrow.compute as pc

    from strawboat.exec.resident import make_resident
    from strawboat.exec.scan import DeviceTable, scan_file

    rng = np.random.default_rng(11)
    n = 3000
    t = pa.table(
        {
            "i32": pa.array(rng.integers(0, 1 << 18, n).astype(np.int32)),
            "i64neg": pa.array(rng.integers(-(10**9), 10**9, n)),
            "f32": pa.array(rng.standard_normal(n).astype(np.float32)),
            "s": pa.array(
                np.array(["aa", "bb", "cc", "dd"])[rng.integers(0, 4, n)]
            ),
            "b": pa.array(rng.random(n) < 0.5),
            "f64": pa.array(np.round(rng.uniform(-100, 100, n), 3)),
            "ni": pa.array(
                [int(v) if m else None
                 for v, m in zip(rng.integers(0, 1000, n), rng.random(n) < 0.8)],
                pa.int64(),
            ),
        },
        schema=pa.schema(
            [
                pa.field("i32", pa.int32(), nullable=False),
                pa.field("i64neg", pa.int64(), nullable=False),
                pa.field("f32", pa.float32(), nullable=False),
                pa.field("s", pa.string(), nullable=False),
                pa.field("b", pa.bool_(), nullable=False),
                pa.field("f64", pa.float64(), nullable=False),
                pa.field("ni", pa.int64(), nullable=True),
            ]
        ),
    )
    p = str(tmp_path / "devdirect.str")
    write_file(p, t, options=WriteOptions(max_page_size=512))
    dt = scan_file(p)
    with mock.patch.object(
        DeviceTable, "to_arrow",
        side_effect=AssertionError("device-direct encode must not to_arrow"),
    ):
        rt = make_resident(dt, tile=512)
    back = rt.to_arrow()
    for f in t.schema:
        exp = t.column(f.name).combine_chunks()
        got = back.column(f.name).combine_chunks()
        if got.type != exp.type:
            got = got.cast(exp.type)
        assert got.equals(exp), f"column {f.name!r} device-direct mismatch"
    # and the fused query paths run over it
    s = int(rt.filter_sum({"i32": (1000, 200000)}, value="i32"))
    v = np.asarray(t.column("i32"))
    assert s == int(v[(v >= 1000) & (v < 200000)].astype(np.int64).sum())


def test_resident_list_int_roundtrip_and_sum(tmp_path):
    """list<int64> loads as a lengths plane + child planes; per-row
    list_sum matches numpy; to_arrow rebuild is exact."""
    rng = np.random.default_rng(21)
    n = 700
    lens = rng.integers(0, 6, n)
    lists = [list(map(int, rng.integers(-50, 1000, k))) for k in lens]
    t = pa.table(
        {"l": pa.array(lists, pa.list_(pa.int64()))},
        schema=pa.schema([pa.field("l", pa.list_(pa.int64()), nullable=False)]),
    )
    rt = _roundtrip(tmp_path, t, "listint.str")
    sums = np.asarray(rt.list_sum("l"))[:n]
    exp = np.array([sum(x) for x in lists], dtype=np.int64)
    assert np.array_equal(sums, exp)


def test_resident_list_utf8_roundtrip(tmp_path):
    rng = np.random.default_rng(22)
    n = 500
    words = ["alpha", "bb", "", "cc", "dddd"]
    lists = [
        [words[int(i)] for i in rng.integers(0, len(words), int(k))]
        for k in rng.integers(0, 4, n)
    ]
    t = pa.table(
        {"ls": pa.array(lists, pa.list_(pa.string()))},
        schema=pa.schema(
            [pa.field("ls", pa.list_(pa.string()), nullable=False)]
        ),
    )
    _roundtrip(tmp_path, t, "listutf8.str")


def test_resident_list_nullable_rows_and_leaves(tmp_path):
    """Null rows and null leaf elements both survive; list_sum treats null
    leaves as 0 and null rows sum to 0."""
    rng = np.random.default_rng(23)
    n = 400
    lists = []
    for i in range(n):
        if rng.random() < 0.2:
            lists.append(None)
        else:
            lists.append(
                [
                    None if rng.random() < 0.3 else round(float(v), 2)
                    for v in rng.uniform(-10, 10, int(rng.integers(0, 5)))
                ]
            )
    t = pa.table(
        {"lf": pa.array(lists, pa.list_(pa.float64()))},
        schema=pa.schema(
            [pa.field("lf", pa.list_(pa.float64()), nullable=True)]
        ),
    )
    rt = _roundtrip(tmp_path, t, "listnull.str")
    sums = np.asarray(rt.list_sum("lf"))[:n]
    exp = np.array(
        [
            0.0 if x is None else sum(v for v in x if v is not None)
            for x in lists
        ]
    )
    assert np.allclose(sums, exp)


def test_resident_list_of_list(tmp_path):
    """list<list<int>> loads by recursion (child is itself a list column)."""
    lists = [[[1, 2], [3]], [], [[4], [], [5, 6, 7]], [[8]]] * 60
    t = pa.table(
        {"ll": pa.array(lists, pa.list_(pa.list_(pa.int64())))},
        schema=pa.schema(
            [pa.field("ll", pa.list_(pa.list_(pa.int64())), nullable=False)]
        ),
    )
    _roundtrip(tmp_path, t, "listlist.str")


def test_resident_empty_table(tmp_path):
    """0-row tables load, roundtrip, and aggregate to zero."""
    t = pa.table(
        {"a": pa.array([], pa.int64()), "s": pa.array([], pa.string())},
        schema=pa.schema(
            [
                pa.field("a", pa.int64(), nullable=False),
                pa.field("s", pa.string(), nullable=False),
            ]
        ),
    )
    rt = _roundtrip(tmp_path, t, "empty.str")
    assert rt.num_rows == 0
    assert int(rt.filter_sum({}, value="a")) == 0


def test_resident_struct_roundtrip_and_query(tmp_path):
    """struct<int, utf8, float> unnests to `parent.field` columns on the
    row grid (the scan layer's convention): roundtrip reassembles the
    struct exactly, and the Query DSL runs on dotted children."""
    from strawboat.exec import Query, col

    rng = np.random.default_rng(31)
    n = 900
    a = rng.integers(0, 1000, n)
    b = np.array(["x", "yy", "zzz"])[rng.integers(0, 3, n)]
    c = np.round(rng.uniform(-5, 5, n), 2)
    st = pa.struct(
        [
            pa.field("a", pa.int64()),
            pa.field("b", pa.string()),
            pa.field("c", pa.float64()),
        ]
    )
    nulls = rng.random(n) < 0.15
    arr = pa.StructArray.from_arrays(
        [pa.array(a), pa.array(b), pa.array(c)],
        fields=list(st),
        mask=pa.array(nulls),
    )
    t = pa.table(
        {"s": arr, "k": pa.array(rng.integers(0, 5, n))},
        schema=pa.schema(
            [
                pa.field("s", st, nullable=True),
                pa.field("k", pa.int64(), nullable=False),
            ]
        ),
    )
    rt = _roundtrip(tmp_path, t, "struct.str")
    assert "s.a" in rt.columns and "s.b" in rt.columns
    # parent struct nulls ride the children's def levels (scan-layer
    # semantics): null rows never aggregate
    got = int(rt.filter_sum({"s.a": (200, 800)}, value="s.a"))
    sel = (a >= 200) & (a < 800) & ~nulls
    assert got == int(a[sel].sum())
    res = (
        Query(rt)
        .filter(col("s.b") == "yy")
        .agg(n=("count", "s.a"))
        .run()
    )
    assert int(res["n"]) == int(((b == "yy") & ~nulls).sum())


def test_resident_struct_nested_struct(tmp_path):
    """struct<struct<int>> recurses (dotted two levels deep)."""
    inner = pa.struct([pa.field("x", pa.int64())])
    outer = pa.struct([pa.field("i", inner), pa.field("y", pa.int64())])
    rows = [{"i": {"x": v}, "y": v * 2} for v in range(400)]
    t = pa.table(
        {"o": pa.array(rows, outer)},
        schema=pa.schema([pa.field("o", outer, nullable=False)]),
    )
    rt = _roundtrip(tmp_path, t, "structnest.str")
    assert "o.i.x" in rt.columns
    assert int(rt.filter_sum({}, value="o.i.x")) == sum(range(400))


def test_make_resident_device_list_falls_back_to_host(tmp_path):
    """A DeviceTable containing a list column routes through the host
    to_arrow fallback (device-direct nested encode is not implemented) and
    still produces a fully working resident table."""
    from strawboat.exec.resident import make_resident
    from strawboat.exec.scan import scan_file

    lists = [[1, 2], [], [3, 4, 5], [6]] * 100
    t = pa.table(
        {
            "l": pa.array(lists, pa.list_(pa.int64())),
            "v": pa.array(np.arange(400, dtype=np.int64)),
        },
        schema=pa.schema(
            [
                pa.field("l", pa.list_(pa.int64()), nullable=False),
                pa.field("v", pa.int64(), nullable=False),
            ]
        ),
    )
    p = str(tmp_path / "devlist.str")
    write_file(p, t, options=WriteOptions(max_page_size=128))
    dt = scan_file(p)
    rt = make_resident(dt, tile=512)
    sums = np.asarray(rt.list_sum("l"))[:400]
    assert sums.tolist() == [sum(x) for x in lists]
    assert int(rt.filter_sum({}, value="v")) == int(np.arange(400).sum())


def test_make_resident_device_direct_decimal(tmp_path):
    """Decimal128 (unscaled-int64 device repr) rides the device-direct
    encoder with wide=True and round-trips through to_arrow exactly."""
    import decimal

    from strawboat.exec.resident import make_resident
    from strawboat.exec.scan import DeviceTable, scan_file

    dt_t = pa.decimal128(12, 2)
    vals = [decimal.Decimal(f"{x}.{x % 100:02d}") for x in range(-200, 300)]
    t = pa.table(
        {"d": pa.array(vals, dt_t)},
        schema=pa.schema([pa.field("d", dt_t, nullable=False)]),
    )
    p = str(tmp_path / "devdec.str")
    write_file(p, t, options=WriteOptions(max_page_size=128))
    sc = scan_file(p)
    with mock.patch.object(
        DeviceTable, "to_arrow",
        side_effect=AssertionError("device-direct must not to_arrow"),
    ):
        rt = make_resident(sc, tile=512)
    back = rt.to_arrow()
    assert back.column("d").combine_chunks().equals(
        t.column("d").combine_chunks()
    )


def test_resident_struct_to_arrow_selection(tmp_path):
    """to_arrow(columns=[struct_name]) reassembles just that struct; dotted
    children are also directly selectable."""
    st = pa.struct([pa.field("a", pa.int64()), pa.field("b", pa.string())])
    rows = [{"a": i, "b": f"s{i % 3}"} for i in range(300)]
    t = pa.table(
        {
            "s": pa.array(rows, st),
            "v": pa.array(np.arange(300, dtype=np.int64)),
        },
        schema=pa.schema(
            [
                pa.field("s", st, nullable=False),
                pa.field("v", pa.int64(), nullable=False),
            ]
        ),
    )
    rt = _roundtrip(tmp_path, t, "structsel.str")
    just_s = rt.to_arrow(columns=["s"])
    assert just_s.schema.names == ["s"]
    assert just_s.column("s").combine_chunks().equals(
        t.column("s").combine_chunks()
    )
    just_child = rt.to_arrow(columns=["s.a"])
    assert np.array_equal(
        np.asarray(just_child.column("s.a")), np.arange(300)
    )
