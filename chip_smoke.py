#!/usr/bin/env python
"""Run the engine's main path once on the GPU and check every result.

    python chip_smoke.py              # one card, TPC-H lineitem at SF10
    python chip_smoke.py --sf 1       # a smaller lineitem
    python chip_smoke.py --chips 4    # only the four-card path

One card runs four phases in one process:

1. device: refuses anything but a GPU; prints the card's name, power limit,
   ``device_kind`` and count;
2. kernels at real widths: the resident plane unpack for every bit width
   0-32 against the host packer (``util/bits``), and the one-hot matmul
   gather and grouped sum against a plain gather and ``segment_sum``, all
   compared exactly and timed against their plain forms;
3. main path: ``write_file`` (zone maps) → ``read_table`` → ``scan_file``
   and ``Query`` Q6/Q1 with zone-map pruning → ``load_resident`` and
   device-direct ``make_resident`` → Q1/Q6 through ``Query`` and
   ``filter_sum`` over both resident tables;
4. codec matrix: each forced codec written small, scanned on the card and
   compared with the host reader.

``--chips 4`` runs the distributed scan, shuffle, aggregate, join and
sharded-resident path over a 1-D mesh of four cards, and nothing else.

Every result is compared with a numpy reference over the same generated
data: integers exactly; float averages with rtol 1e-12, because the device
sums in another order.  A failed check raises, so the script exits non-zero
and prints no result line.  The last line is one JSON object naming the
device.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np

Q6_COLS = ["l_shipdate", "l_discount", "l_quantity", "l_extendedprice"]
Q1_COLS = [
    "l_returnflag", "l_linestatus", "l_quantity", "l_extendedprice",
    "l_discount", "l_tax", "l_shipdate",
]
Q1_INT_AGGS = (
    "sum_qty", "sum_base_price", "sum_disc_price", "sum_charge", "count_order",
)
Q1_FLOAT_AGGS = ("avg_qty", "avg_price", "avg_disc")
FLOAT_RTOL = 1e-12  # device float64 sums in another order than numpy


def log(msg: str) -> None:
    print(msg, flush=True)


def check(ok, what: str) -> None:
    if not ok:
        raise RuntimeError(f"check failed: {what}")


def timed(fn):
    """(result, seconds) with the device work finished inside the window."""
    import jax

    t0 = time.perf_counter()
    out = jax.block_until_ready(fn())
    return out, time.perf_counter() - t0


def cold_warm(label: str, fn):
    """Run twice: the first call includes compilation, the second not."""
    out, cold = timed(fn)
    out, warm = timed(fn)
    log(f"  {label}: cold {cold:.4f}s warm {warm:.4f}s")
    return out


def best_of(fn, reps: int = 3) -> float:
    """Best time of ``reps`` runs after one warm-up run."""
    timed(fn)
    return min(timed(fn)[1] for _ in range(reps))


def gpu_query() -> str:
    """``nvidia-smi`` name and power limit (a child process, off JAX)."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return out.stdout.strip()


def device_or_exit(count: int):
    import jax

    devs = jax.devices()
    if devs[0].platform != "gpu":
        sys.stderr.write(
            f"chip_smoke: needs a GPU, JAX found {devs[0].platform}\n"
        )
        sys.exit(2)
    if len(devs) < count:
        sys.stderr.write(f"chip_smoke: needs {count} GPUs, found {len(devs)}\n")
        sys.exit(2)
    return devs


def general_codec():
    """First general codec whose system library this host has."""
    from strawboat.codecs import common
    from strawboat.constants import Compression

    for codec, lib in (
        (Compression.LZ4, common._lz4),
        (Compression.ZSTD, common._zstd),
        (Compression.SNAPPY, common._snappy),
    ):
        if lib is not None:
            return codec
    raise RuntimeError("no general codec library on this host")


def peak_bytes() -> int:
    import jax

    return int(jax.devices()[0].memory_stats().get("peak_bytes_in_use", 0))


# ---------------------------------------------------------------------------
# phase 2: kernels at real widths


def phase_kernels(n_rows: int, seed: int) -> None:
    import jax
    import jax.numpy as jnp

    from strawboat.exec.aggregate import dense_group_sum
    from strawboat.exec.resident import (
        TILE3D,
        _slot_source_index,
        _unpack_plane_tiled,
        transpose_words_host_tiled,
    )
    from strawboat.kernels.gather import mxu_gather
    from strawboat.util.bits import pack_blocks

    rng = np.random.default_rng(seed)
    n_tiles = 8
    n = n_tiles * 32 * TILE3D
    src = _slot_source_index(n_tiles, TILE3D)
    unpack = jax.jit(_unpack_plane_tiled, static_argnums=1)
    t0 = time.perf_counter()
    for b in range(33):
        vals = rng.integers(0, 1 << b, n, dtype=np.uint64).astype(np.uint32)
        if b == 0:
            wt3 = np.zeros((n_tiles, 0, TILE3D), np.uint32)
        else:
            words = pack_blocks(vals.reshape(-1, 128), b).reshape(-1)
            wt3 = transpose_words_host_tiled(words, b)
        got = np.asarray(unpack(jnp.asarray(wt3), b))
        check(np.array_equal(got, vals[src]), f"plane unpack b={b}")
    log(
        f"  plane unpack: widths 0-32 exact over {n} values each "
        f"({time.perf_counter() - t0:.2f}s incl. compiles)"
    )

    # dictionary decode shape: a sorted 50-entry int64 dictionary (the
    # l_quantity column's) gathered by n_rows codes
    table = jnp.asarray(np.sort(rng.choice(1 << 40, 50, replace=False)))
    ids = jnp.asarray(rng.integers(0, 50, n_rows).astype(np.int32))
    plain_gather = jax.jit(lambda t, i: t[i])
    got, want = mxu_gather(table, ids), plain_gather(table, ids)
    check(bool(jnp.array_equal(got, want)), "mxu_gather == table[ids]")
    t_onehot = best_of(lambda: mxu_gather(table, ids))
    t_plain = best_of(lambda: plain_gather(table, ids))
    log(
        f"  gather {n_rows} ids, 50-entry table: one-hot matmul "
        f"{t_onehot * 1e3:.3f} ms, plain gather {t_plain * 1e3:.3f} ms"
    )

    # grouped sum shape: Q1's 6 composite groups over n_rows int64 values
    codes = jnp.asarray(rng.integers(0, 6, n_rows).astype(np.int32))
    values = jnp.asarray(rng.integers(0, 5_500_000, n_rows).astype(np.int64))
    mask = jnp.asarray(rng.random(n_rows) < 0.98)

    @jax.jit
    def plain_group_sum(c, v, m):
        seg = jnp.where(m, c, 6)
        s = jax.ops.segment_sum(jnp.where(m, v, 0), seg, num_segments=7)[:6]
        k = jax.ops.segment_sum(m.astype(jnp.int64), seg, num_segments=7)[:6]
        return s, k

    s1, k1 = dense_group_sum(codes, values, 6, mask=mask)
    s2, k2 = plain_group_sum(codes, values, mask)
    check(
        bool(jnp.array_equal(s1, s2)) and bool(jnp.array_equal(k1, k2)),
        "dense_group_sum == segment_sum",
    )
    t_onehot = best_of(lambda: dense_group_sum(codes, values, 6, mask=mask))
    t_plain = best_of(lambda: plain_group_sum(codes, values, mask))
    log(
        f"  grouped sum {n_rows} rows, 6 groups: one-hot matmul "
        f"{t_onehot * 1e3:.3f} ms, segment_sum {t_plain * 1e3:.3f} ms"
    )


# ---------------------------------------------------------------------------
# numpy references over the generated lineitem


def q6_reference(table) -> int:
    from strawboat.benchsuite.tpch import q6_numpy_reference

    return q6_numpy_reference(table)


def q1_reference(table, cutoff: int):
    import pyarrow.compute as pc

    def codes(name):
        enc = pc.dictionary_encode(table.column(name)).combine_chunks()
        return enc.indices.to_numpy(), enc.dictionary.to_pylist()

    rf, rf_dict = codes("l_returnflag")
    ls, ls_dict = codes("l_linestatus")
    sd = table.column("l_shipdate").to_numpy()
    qty = table.column("l_quantity").to_numpy()
    ep = table.column("l_extendedprice").to_numpy()
    disc = table.column("l_discount").to_numpy()
    tax = table.column("l_tax").to_numpy()
    live = sd <= cutoff
    out = {}
    for i, f in enumerate(rf_dict):
        for j, s in enumerate(ls_dict):
            g = live & (rf == i) & (ls == j)
            n = int(g.sum())
            if not n:
                continue
            dp = ep[g] * (100 - disc[g])
            out[(f, s)] = {
                "sum_qty": int(qty[g].sum()),
                "sum_base_price": int(ep[g].sum()),
                "sum_disc_price": int(dp.sum()),
                "sum_charge": int((dp * (100 + tax[g])).sum()),
                "count_order": n,
                "avg_qty": float(qty[g].sum()) / n,
                "avg_price": float(ep[g].sum()) / n,
                "avg_disc": float(disc[g].sum()) / n,
            }
    return out


def q1_groups(res):
    """Grouped ``Query`` result → {(flag, status): {agg: value}}."""
    out = {}
    for i in range(int(res["n_groups"])):
        key = []
        for k in ("l_returnflag", "l_linestatus"):
            v = res[f"dict_{k}"][int(np.asarray(res[f"key_{k}"])[i])].as_py()
            key.append(v.decode() if isinstance(v, bytes) else v)
        out[tuple(key)] = {
            a: np.asarray(res[a])[i] for a in Q1_INT_AGGS + Q1_FLOAT_AGGS
        }
    return out


def check_q1(res, ref, label: str) -> None:
    got = q1_groups(res)
    check(set(got) == set(ref), f"{label}: groups {sorted(got)}")
    for key, want in ref.items():
        for a in Q1_INT_AGGS:
            check(int(got[key][a]) == want[a], f"{label}: {key} {a}")
        for a in Q1_FLOAT_AGGS:
            check(
                np.isclose(float(got[key][a]), want[a], rtol=FLOAT_RTOL, atol=0),
                f"{label}: {key} {a}",
            )


def q1_query(source):
    from strawboat.benchsuite.tpch import EPOCH_DAYS, Q1_DEFAULT_DELTA, _q1_aggs
    from strawboat.exec import Query, col

    return (
        Query(source)
        .filter(col("l_shipdate") <= EPOCH_DAYS - Q1_DEFAULT_DELTA)
        .group_by("l_returnflag", "l_linestatus", num_groups=16)
        .agg(**_q1_aggs())
    )


def q6_query(source):
    from strawboat.exec import Query, col

    return (
        Query(source)
        .filter(
            (col("l_shipdate") >= 731)
            & (col("l_shipdate") < 1096)
            & (col("l_discount") >= 5)
            & (col("l_discount") <= 7)
            & (col("l_quantity") < 24)
        )
        .agg(revenue=("sum", col("l_extendedprice") * col("l_discount")))
    )


Q6_BOUNDS = {
    "l_shipdate": (731, 1096),
    "l_discount": (5, 8),
    "l_quantity": (None, 24),
}


def write_lineitem(sf: float, seed: int, path: str, codec):
    from strawboat.api import write_file
    from strawboat.benchsuite.tpch import generate_lineitem
    from strawboat.codecs import WriteOptions

    t0 = time.perf_counter()
    table = generate_lineitem(sf, seed=seed)
    log(f"  generate lineitem SF{sf:g}: {table.num_rows} rows "
        f"({time.perf_counter() - t0:.2f}s)")
    opts = WriteOptions(
        default_compression=codec,
        max_page_size=65536,
        sample_seed=seed,
        zone_maps=True,
    )
    _, t = timed(lambda: write_file(path, table, options=opts))
    log(f"  write_file: {t:.3f}s, {os.path.getsize(path)} bytes")
    return table


# ---------------------------------------------------------------------------
# phase 3: main path


def resident_bytes(rt) -> int:
    total = 0
    for c in rt.columns.values():
        total += sum(int(w.size) * 4 for w, _b in c.planes)
        if c.validity_plane is not None:
            total += int(c.validity_plane.size) * 4
    return total


def run_resident_queries(rt, label: str, ref1, ref6) -> None:
    q1 = q1_query(rt)
    check_q1(cold_warm(f"{label} Q1 Query", q1.run), ref1, f"{label} Q1")
    q6 = q6_query(rt)
    got = cold_warm(f"{label} Q6 Query", q6.run)
    check(int(got["revenue"]) == ref6, f"{label} Q6 Query")
    got = cold_warm(
        f"{label} Q6 filter_sum",
        lambda: rt.filter_sum(
            Q6_BOUNDS, value="l_extendedprice", product_with="l_discount"
        ),
    )
    check(int(got) == ref6, f"{label} Q6 filter_sum")


def phase_main(sf: float, seed: int, workdir: str, codec) -> None:
    from strawboat.api import read_table
    from strawboat.benchsuite.tpch import (
        EPOCH_DAYS,
        Q1_DEFAULT_DELTA,
        q6,
        q6_pruning_predicates,
    )
    from strawboat.exec import load_resident, make_resident, scan_file

    path = os.path.join(workdir, "lineitem.str")
    table = write_lineitem(sf, seed, path, codec)
    back, t = timed(lambda: read_table(path))
    check(back.equals(table), "read_table round trip")
    log(f"  read_table: {t:.3f}s, equal to the written table")
    del back
    t0 = time.perf_counter()
    ref6 = q6_reference(table)
    ref1 = q1_reference(table, EPOCH_DAYS - Q1_DEFAULT_DELTA)
    log(f"  numpy references: {time.perf_counter() - t0:.2f}s")

    dt = cold_warm("scan_file Q6 columns", lambda: scan_file(path, columns=Q6_COLS))
    check(int(cold_warm("Q6 over scan", lambda: q6(dt))) == ref6, "scan Q6")
    del dt
    preds = q6_pruning_predicates()
    dt = cold_warm(
        "scan_file Q6 columns, zone-map pruned",
        lambda: scan_file(path, columns=Q6_COLS, predicates=preds),
    )
    check(int(q6(dt)) == ref6, "pruned scan Q6")
    log(f"  pruned scan kept {dt.num_rows} of {table.num_rows} rows")
    del dt
    got = cold_warm("Q6 Query over the file (pruned)", q6_query(path).run)
    check(int(got["revenue"]) == ref6, "file Q6 Query")
    check_q1(
        cold_warm("Q1 Query over the file (pruned)", q1_query(path).run),
        ref1, "file Q1",
    )

    rt, t = timed(lambda: load_resident(path, columns=Q1_COLS))
    log(f"  load_resident: {t:.3f}s, plane bytes {resident_bytes(rt)}")
    run_resident_queries(rt, "load_resident", ref1, ref6)
    del rt

    dt = scan_file(path, columns=Q1_COLS)
    rt, t = timed(lambda: make_resident(dt))
    del dt
    log(f"  make_resident(DeviceTable): {t:.3f}s, plane bytes "
        f"{resident_bytes(rt)}")
    run_resident_queries(rt, "make_resident", ref1, ref6)


# ---------------------------------------------------------------------------
# phase 4: codec matrix


def _codec_case(kind: str, n: int, rng):
    import pyarrow as pa

    if kind == "bp":
        return pa.array(rng.integers(0, 1 << 11, n).astype(np.uint32))
    if kind == "lowcard":
        return pa.array(rng.integers(0, 37, n).astype(np.int64))
    if kind == "runs":
        return pa.array(np.repeat(rng.integers(0, 100, n // 64), 64).astype(np.int64))
    if kind == "skewed":
        vals = np.full(n, 42, dtype=np.int64)
        idx = rng.choice(n, n // 50, replace=False)
        vals[idx] = rng.integers(0, 1000, len(idx))
        return pa.array(vals)
    if kind == "floats":
        return pa.array(np.cumsum(rng.random(n)) * 0.001)
    if kind == "random":
        return pa.array(rng.integers(0, 1 << 40, n).astype(np.int64))
    if kind == "sorted":
        return pa.array(np.sort(rng.integers(0, 1 << 20, n)).astype(np.uint32))
    if kind == "strings":
        words = np.array([f"w{i}" for i in range(50)])
        return pa.array(words[rng.integers(0, 50, n)].tolist(), pa.string())
    raise ValueError(kind)


CODEC_CASES = (
    # (label, forcing env var, data)
    ("bitpack", "STRAWBOAT_BITPACK_COMPRESSION", "bp"),
    ("dict", "STRAWBOAT_DICT_COMPRESSION", "lowcard"),
    ("rle", "STRAWBOAT_RLE_COMPRESSION", "runs"),
    ("freq", "STRAWBOAT_FREQ_COMPRESSION", "skewed"),
    ("patas", "STRAWBOAT_PATAS_COMPRESSION", "floats"),
    ("delta", None, "sorted"),
    ("strings_dict", "STRAWBOAT_DICT_COMPRESSION", "strings"),
)


def phase_codecs(workdir: str, codec, seed: int) -> None:
    import pyarrow as pa

    from strawboat.api import read_table, write_file
    from strawboat.codecs import WriteOptions, common
    from strawboat.constants import Compression
    from strawboat.exec import scan_file

    n = 65536
    cases = [(lab, var, kind, codec) for lab, var, kind in CODEC_CASES]
    for general, lib in (
        (Compression.LZ4, common._lz4),
        (Compression.ZSTD, common._zstd),
        (Compression.SNAPPY, common._snappy),
    ):
        if lib is None:
            log(f"  {general.name.lower():14s} skipped: library not on this host")
        else:
            cases.append((general.name.lower(), None, "random", general))
    for label, env_var, kind, general in cases:
        table = pa.table({"a": _codec_case(kind, n, np.random.default_rng(seed))})
        path = os.path.join(workdir, f"codec_{label}.str")
        opts = WriteOptions(
            default_compression=general,
            max_page_size=8192,
            default_compress_ratio=1.0 if kind == "sorted" else None,
            sample_seed=0,
        )
        if env_var:
            os.environ[env_var] = "1"
        try:
            write_file(path, table, options=opts)
        finally:
            if env_var:
                del os.environ[env_var]
        got = scan_file(path).to_arrow().column("a").combine_chunks()
        want = read_table(path).column("a").combine_chunks()
        check(got.equals(want), f"codec {label}: device scan == host reader")
        check(want.equals(table.column("a").combine_chunks()), f"codec {label}")
        log(f"  {label:14s} ok ({n} rows)")


# ---------------------------------------------------------------------------
# --chips 4: the multi-card path


def phase_multichip(sf: float, seed: int, workdir: str, codec, n_chips: int) -> None:
    import jax.numpy as jnp
    import pyarrow as pa

    from strawboat.api import write_file
    from strawboat.codecs import WriteOptions
    from strawboat.exec import load_resident
    from strawboat.parallel import (
        distributed_aggregate,
        distributed_join,
        distributed_scan,
        make_mesh,
        shard_resident,
        shuffle_by_key,
    )
    from strawboat.parallel.dist_resident import (
        sharded_filter_sum,
        sharded_group_sum,
    )

    mesh = make_mesh(n_chips)
    log(f"  mesh: {n_chips} devices on axis 'shards'")
    path = os.path.join(workdir, "lineitem.str")
    table = write_lineitem(sf, seed, path, codec)
    supp = table.column("l_suppkey").to_numpy()
    ep = table.column("l_extendedprice").to_numpy()
    n_supp = int(supp.max()) + 1

    cols = ["l_suppkey", "l_extendedprice"] + Q6_COLS[:3]
    ft = cold_warm(
        "distributed_scan", lambda: distributed_scan(path, mesh, columns=cols)
    )
    valid = ft["__valid__"].values
    got = int(jnp.sum(jnp.where(valid, ft["l_extendedprice"].values, 0)))
    check(got == int(ep.sum()), "distributed_scan sum(l_extendedprice)")
    check(int(jnp.sum(valid)) == table.num_rows, "distributed_scan row count")

    # shuffle by supplier, then aggregate per supplier
    # the scan's padding rows travel too, so the row mask rides as a payload
    cap = int(valid.shape[0]) // n_chips // n_chips * 5 // 4
    sh_key, (sh_v, sh_row), sh_valid = cold_warm(
        "shuffle_by_key l_suppkey",
        lambda: shuffle_by_key(
            mesh, "shards", ft["l_suppkey"].values,
            (ft["l_extendedprice"].values, valid), capacity=cap,
        ),
    )
    sh_mask = sh_valid & sh_row
    check(int(jnp.sum(sh_mask)) == table.num_rows, "shuffle row count")
    check(
        int(jnp.sum(jnp.where(sh_mask, sh_v, 0))) == int(ep.sum()),
        "shuffle sum(l_extendedprice)",
    )
    res = cold_warm(
        "distributed_aggregate per supplier",
        lambda: distributed_aggregate(
            mesh, "shards", sh_key,
            {"total": ("sum", sh_v), "cnt": ("count", sh_v)},
            mask=sh_mask,
            num_groups=1 << (2 * n_supp // n_chips).bit_length(),
        ),
    )
    ok = np.asarray(res["valid"])
    keys = np.asarray(res["keys"])[ok]
    want_total = np.zeros(n_supp, np.int64)
    np.add.at(want_total, supp, ep)
    want_cnt = np.bincount(supp, minlength=n_supp)
    check(len(keys) == int((want_cnt > 0).sum()), "aggregate group count")
    check(
        np.array_equal(np.asarray(res["total"])[ok], want_total[keys]),
        "aggregate per-supplier sums",
    )
    check(
        np.array_equal(np.asarray(res["cnt"])[ok], want_cnt[keys]),
        "aggregate per-supplier counts",
    )

    # join to a supplier dimension (suppkey → nation), then sum by nation
    nation = np.random.default_rng(seed + 1).integers(0, 25, n_supp)
    dim = pa.table({
        "s_suppkey": pa.array(np.arange(n_supp, dtype=np.int64)),
        "s_nationkey": pa.array(nation.astype(np.int64)),
    })
    dpath = os.path.join(workdir, "supplier.str")
    write_file(dpath, dim, options=WriteOptions(default_compression=codec))
    dt = distributed_scan(dpath, mesh)
    _jkey, (jv,), (jnat,), jvalid = cold_warm(
        "distributed_join lineitem ⋈ supplier",
        lambda: distributed_join(
            mesh, "shards",
            ft["l_suppkey"].values, (ft["l_extendedprice"].values,),
            dt["s_suppkey"].values, (dt["s_nationkey"].values,),
            probe_valid=valid, build_valid=dt["__valid__"].values,
        ),
    )
    res = distributed_aggregate(
        mesh, "shards", jnat, {"total": ("sum", jv)}, mask=jvalid, num_groups=64
    )
    ok = np.asarray(res["valid"])
    got = dict(zip(np.asarray(res["keys"])[ok].tolist(),
                   np.asarray(res["total"])[ok].tolist()))
    want_nat = np.zeros(25, np.int64)
    np.add.at(want_nat, nation[supp], ep)
    want = {int(k): int(v) for k, v in enumerate(want_nat) if v}
    check(got == want, "join + aggregate by nation")

    # sharded resident planes: Q6 filter_sum and a per-flag grouped sum
    rt = load_resident(path, columns=Q1_COLS)
    srt = cold_warm("shard_resident", lambda: shard_resident(rt, mesh, "shards"))
    got = cold_warm(
        "sharded_filter_sum Q6",
        lambda: sharded_filter_sum(
            srt, Q6_BOUNDS, value="l_extendedprice", product_with="l_discount"
        ),
    )
    check(int(got) == q6_reference(table), "sharded_filter_sum Q6")
    rf_dict = srt.columns["l_returnflag"].dictionary_host
    (sq, sp), cnt = cold_warm(
        "sharded_group_sum by l_returnflag",
        lambda: sharded_group_sum(
            srt, "l_returnflag", ["l_quantity", "l_extendedprice"],
            num_groups=len(rf_dict),
        ),
    )
    rf = np.asarray(table.column("l_returnflag").to_numpy(zero_copy_only=False))
    qty = table.column("l_quantity").to_numpy()
    for g, flag in enumerate(rf_dict):
        sel = rf == flag
        check(int(np.asarray(sq)[g]) == int(qty[sel].sum()), f"group {flag} qty")
        check(int(np.asarray(sp)[g]) == int(ep[sel].sum()), f"group {flag} price")
        check(int(np.asarray(cnt)[g]) == int(sel.sum()), f"group {flag} count")


# ---------------------------------------------------------------------------


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--sf", type=float, default=10.0, help="TPC-H scale factor")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--chips", type=int, default=1, choices=(1, 4))
    args = ap.parse_args(argv)

    import jax

    import strawboat.kernels  # noqa: F401  (x64 and the compile cache)
    from strawboat import native

    devs = device_or_exit(args.chips)
    log("phase 1: device")
    log(f"  nvidia-smi: {gpu_query()}")
    log(f"  jax: platform {devs[0].platform}, kind {devs[0].device_kind}, "
        f"count {len(devs)}, compile cache {jax.config.jax_compilation_cache_dir}")
    err = native.load_error()
    log(f"  native runtime: {'loaded' if err is None else 'NOT loaded: ' + err}")
    codec = general_codec()
    log(f"  general codec: {codec.name}")

    phases = []
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as workdir:
        if args.chips == 4:
            phases.append(("multi-card path", lambda: phase_multichip(
                args.sf, args.seed, workdir, codec, 4)))
        else:
            n_rows = int(6_000_000 * args.sf)
            phases += [
                ("kernels", lambda: phase_kernels(n_rows, args.seed)),
                ("main path", lambda: phase_main(args.sf, args.seed, workdir, codec)),
                ("codec matrix", lambda: phase_codecs(workdir, codec, args.seed)),
            ]
        for i, (name, fn) in enumerate(phases, start=2):
            log(f"phase {i}: {name}")
            t0 = time.perf_counter()
            fn()
            log(f"  phase {name}: {time.perf_counter() - t0:.2f}s, device peak "
                f"bytes {peak_bytes()}")
    log(f"gpu: {gpu_query()}")
    print(json.dumps({
        "ok": True,
        "device": {
            "platform": devs[0].platform,
            "kind": devs[0].device_kind,
            "count": len(devs),
        },
    }), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
