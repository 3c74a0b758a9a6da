"""Benchmarks on the GPU — one JSON line per metric.

Metrics (in print order; the headline is the last line):
  host_read_bandwidth          — config 1 host read A/B vs pyarrow
                                 parquet-C++ (the reference's own A/B:
                                 strawboat_read.rs vs parquet_read.rs)
  host_read_bandwidth_recycled — same with ReadArena buffer recycling
                                 (reference swap_buffer semantics)
  write_throughput             — config 1 write A/B vs parquet-C++
  e2e_scan_bandwidth           — config 1 file → decoded column in device
                                 memory (host read + PCIe upload + decode)
  tpch_sf1_host_scan_rows_per_s— SF1 Q6-columns read + numpy Q6 vs the same
                                 pipeline over parquet (host-only A/B)
  bulk_write_rows_per_s        — SF1 lineitem write A/B vs parquet-C++
  tpch_sf1_scan_rows_per_s     — config 4: scan → device + Q6, no pruning
  tpch_sf1_pruned_speedup      — same with zone-map page pruning
  tpch_q1_latency_ms           — full Q1 (8 aggs, utf8 keys) over a scan
  tpch_q6_latency_ms           — Q6 over a scan
  resident_scan_bandwidth      — device-resident packed planes → fused
                                 decode + filter + sum
  resident_load_s              — load_resident vs the host read it feeds
  resident_q1_latency_ms       — full TPC-H Q1 over resident planes
  bitpack_decode_bandwidth     — HEADLINE: the resident plane unpack alone,
                                 moved = packed input + decoded output,
                                 vs_baseline = achieved / peak device memory
                                 bandwidth of the card (``PEAKS``).

Every line names the platform, ``device_kind``, device count and the
card's power limit.  Times are host-clock windows that end in
``block_until_ready`` (or a host fetch), best of several repetitions after
a warm-up.  The run needs a GPU whose kind is in ``PEAKS``; any failure
fails the run.  Run: ``python bench.py``.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np

# Published peaks per device kind (NVIDIA H100 SXM data sheet: 80 GB HBM3
# at 3.35 TB/s, at the full 700 W power limit).
PEAKS = {
    "NVIDIA H100 80GB HBM3": {"hbm_gbps": 3350.0},
}

_DEVICE = {}


def device_header() -> dict:
    """platform / kind / count / power limit of the card (once)."""
    if not _DEVICE:
        import jax

        d = jax.devices()
        if d[0].platform != "gpu":
            raise SystemExit(f"bench.py needs a GPU, JAX found {d[0].platform}")
        if d[0].device_kind not in PEAKS:
            raise SystemExit(f"no peak table entry for {d[0].device_kind!r}")
        smi = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60, check=True,
        ).stdout.strip().splitlines()[0]
        _DEVICE.update(
            platform=d[0].platform,
            device_kind=d[0].device_kind,
            device_count=len(d),
            power_limit=smi.split(",")[-1].strip(),
        )
    return _DEVICE


def emit(metric, value, unit, vs_baseline, **extra):
    row = {
        "metric": metric,
        "value": float(value),
        "unit": unit,
        "vs_baseline": float(vs_baseline),
    }
    row.update(extra)
    row.update(device_header())
    print(json.dumps(row), flush=True)
    return row


def _timed(fn):
    import jax

    t0 = time.perf_counter()
    jax.block_until_ready(fn())
    return time.perf_counter() - t0


def _best(fn, k: int = 4) -> float:
    _timed(fn)  # warm-up: compilation and page cache
    return min(_timed(fn) for _ in range(k))


def _med(xs):
    return sorted(xs)[len(xs) // 2]


def bench_e2e_scan(tmpdir: str):
    """Config 1: Int64/LZ4 file read — host A/B vs parquet-C++, then the
    same file scanned into device memory."""
    import pyarrow as pa
    import pyarrow.parquet as pq

    from strawboat.api import read_table, write_file
    from strawboat.codecs import WriteOptions
    from strawboat.constants import Compression
    from strawboat.exec import scan_file
    from strawboat.read.fast import ReadArena

    n = int(os.environ.get("SB_E2E_ROWS", 1 << 24))  # 16.7M rows = 134 MB
    rng = np.random.default_rng(0)
    table = pa.table({"a": pa.array(rng.integers(0, 1 << 40, n, dtype=np.int64))})
    opts = WriteOptions(
        default_compression=Compression.LZ4,
        default_compress_ratio=None,
        max_page_size=65536,
    )
    path = os.path.join(tmpdir, "config1.str")
    write_file(path, table, options=opts)
    ppath = os.path.join(tmpdir, "config1.parquet")
    pq.write_table(table, ppath, compression="lz4")

    pq_gbps = n * 8 / _best(lambda: pq.read_table(ppath)) / 1e9
    host_gbps = n * 8 / _best(lambda: read_table(path)) / 1e9
    emit("host_read_bandwidth", host_gbps, "GB/s", host_gbps / pq_gbps,
         parquet_read_gbps=pq_gbps)
    arena = ReadArena()
    arena_gbps = n * 8 / _best(lambda: read_table(path, arena=arena)) / 1e9
    emit("host_read_bandwidth_recycled", arena_gbps, "GB/s",
         arena_gbps / pq_gbps, parquet_read_gbps=pq_gbps)

    t_w = _best(lambda: write_file(os.path.join(tmpdir, "w.str"), table, options=opts))
    t_wpq = _best(lambda: pq.write_table(
        table, os.path.join(tmpdir, "w.parquet"), compression="lz4"))
    emit("write_throughput", n * 8 / t_w / 1e9, "GB/s", t_wpq / t_w,
         parquet_write_gbps=n * 8 / t_wpq / 1e9)

    gbps = n * 8 / _best(lambda: scan_file(path)["a"].values) / 1e9
    emit("e2e_scan_bandwidth", gbps, "GB/s", gbps / pq_gbps,
         note="host read + upload + device decode; vs parquet-C++ host read")


def bench_tpch(tmpdir: str):
    """Config 4: TPC-H SF1 scan rows/s ± pruning, Q1/Q6 latency."""
    import pyarrow.parquet as pq

    from strawboat.api import read_table, write_file
    from strawboat.benchsuite.tpch import (
        generate_lineitem,
        q1_dense,
        q1_numpy_reference,
        q6,
        q6_numpy_reference,
        q6_pruning_predicates,
    )
    from strawboat.codecs import WriteOptions
    from strawboat.constants import Compression
    from strawboat.exec import scan_file

    n_rows = int(os.environ.get("SB_TPCH_ROWS", 6_000_000))
    table = generate_lineitem(scale=1.0, rows=n_rows)
    opts = WriteOptions(
        default_compression=Compression.LZ4,
        default_compress_ratio=1.0,
        max_page_size=65536,
        sample_seed=3,
        zone_maps=True,
    )
    path = os.path.join(tmpdir, "lineitem_sf1.str")
    write_file(path, table, options=opts)
    ppath = os.path.join(tmpdir, "lineitem_sf1.parquet")
    pq.write_table(table, ppath, compression="lz4")
    q6_cols = ["l_shipdate", "l_discount", "l_quantity", "l_extendedprice"]
    want6 = q6_numpy_reference(table)

    # host-only A/B: our reader + numpy Q6 vs parquet-C++ + numpy Q6,
    # interleaved so both pipelines see the same host noise
    def host_q6(reader):
        if q6_numpy_reference(reader()) != want6:
            raise RuntimeError("host Q6 disagrees with the reference")

    def pq_q6():
        host_q6(lambda: pq.read_table(ppath, columns=q6_cols))

    def our_q6():
        host_q6(lambda: read_table(path, columns=q6_cols))

    pq_q6(), our_q6()
    l_pq, l_host = [], []
    for _ in range(5):
        l_pq.append(_timed(pq_q6))
        l_host.append(_timed(our_q6))
    t_pq, t_host = min(l_pq), min(l_host)
    emit("tpch_sf1_host_scan_rows_per_s", n_rows / t_host, "rows/s",
         t_pq / t_host, parquet_numpy_rows_per_s=n_rows / t_pq,
         median_ratio=_med(l_pq) / _med(l_host), n=len(l_host))

    wpath = os.path.join(tmpdir, "wr_ab.str")
    wppath = os.path.join(tmpdir, "wr_ab.parquet")
    l_w, l_wp = [], []
    for _ in range(2):
        l_w.append(_timed(lambda: write_file(wpath, table, options=opts)))
        l_wp.append(_timed(lambda: pq.write_table(table, wppath, compression="lz4")))
    emit("bulk_write_rows_per_s", n_rows / min(l_w), "rows/s",
         min(l_wp) / min(l_w), parquet_cpp_rows_per_s=n_rows / min(l_wp),
         our_bytes=os.path.getsize(wpath), parquet_bytes=os.path.getsize(wppath))

    def scan_q6(predicates):
        rev = q6(scan_file(path, columns=q6_cols, predicates=predicates))
        if int(rev) != want6:
            raise RuntimeError("device Q6 disagrees with the reference")

    preds = q6_pruning_predicates()
    t_full = _best(lambda: scan_q6(None), 3)
    t_pruned = _best(lambda: scan_q6(preds), 3)
    emit("tpch_sf1_scan_rows_per_s", n_rows / t_full, "rows/s", t_pq / t_full,
         parquet_numpy_rows_per_s=n_rows / t_pq)
    emit("tpch_sf1_pruned_speedup", t_full / t_pruned, "x", t_full / t_pruned)

    dt = scan_file(path)
    want1 = q1_numpy_reference(table)
    got1 = q1_dense(dt)
    for i, (f, s) in enumerate(zip(got1.column("l_returnflag").to_pylist(),
                                   got1.column("l_linestatus").to_pylist())):
        if got1.column("sum_charge")[i].as_py() != want1[(f, s)]["sum_charge"]:
            raise RuntimeError("device Q1 disagrees with the reference")
    t_q1 = _best(lambda: q1_dense(dt), 3)
    t_q6 = _best(lambda: q6(dt), 3)
    t_q1_np = _best(lambda: q1_numpy_reference(table), 1)
    t_q6_np = _best(lambda: q6_numpy_reference(table), 1)
    emit("tpch_q1_latency_ms", t_q1 * 1e3, "ms", t_q1_np / t_q1)
    emit("tpch_q6_latency_ms", t_q6 * 1e3, "ms", t_q6_np / t_q6)


def bench_resident_scan():
    """Resident plane → fused unpack + filter + sum (the Q6 shape of one
    column); returns the unpack-alone headline row."""
    import jax
    import jax.numpy as jnp

    from strawboat.exec.resident import TILE3D, _pack_plane, _unpack_plane_tiled

    n = int(os.environ.get("SB_RESIDENT_ROWS", 1 << 26))
    b = 16
    vals = np.random.default_rng(0).integers(0, 1 << b, n, dtype=np.uint32)
    wt3 = _pack_plane(vals, b, TILE3D)
    packed = int(wt3.size) * 4
    decoded = int(wt3.shape[0]) * 32 * TILE3D * 4

    @jax.jit
    def scan(w):
        v = _unpack_plane_tiled(w, b).astype(jnp.int32)
        m = (jnp.arange(v.shape[0]) < n) & (v >= 1000) & (v < 30000)
        return jnp.sum(jnp.where(m, v, 0), dtype=jnp.int64)

    sel = (vals >= 1000) & (vals < 30000)
    if int(scan(wt3)) != int(vals[sel].astype(np.int64).sum()):
        raise RuntimeError("resident scan sum disagrees with numpy")
    t = _best(lambda: scan(wt3), 10)
    peak = PEAKS[device_header()["device_kind"]]["hbm_gbps"]
    emit("resident_scan_bandwidth", n * 4 / t / 1e9, "GB/s",
         packed / t / 1e9 / peak, packed_bytes=packed,
         unit_note="decoded int32 bytes/s incl. filter+sum; vs_baseline = "
         "packed bytes read / peak device memory bandwidth")

    unpack = jax.jit(_unpack_plane_tiled, static_argnums=1)
    if not np.array_equal(np.asarray(unpack(wt3, b))[:n], vals):
        raise RuntimeError("plane unpack disagrees with the packed values")
    t = _best(lambda: unpack(wt3, b), 10)
    moved = packed + decoded
    return {
        "metric": "bitpack_decode_bandwidth",
        "value": moved / t / 1e9,
        "unit": "GB/s",
        "vs_baseline": moved / t / 1e9 / peak,
        "moved_bytes": moved,
        "note": "resident plane unpack alone (b=16), packed read + decoded "
        "write; vs_baseline = share of peak device memory bandwidth",
    }


def bench_resident_q1(tmpdir: str):
    """TPC-H Q1 over a resident table: the fused one-jit grouped path."""
    from strawboat.api import read_table, write_file
    from strawboat.benchsuite.tpch import (
        EPOCH_DAYS,
        Q1_DEFAULT_DELTA,
        _q1_aggs,
        generate_lineitem,
        q1_numpy_reference,
    )
    from strawboat.codecs import WriteOptions
    from strawboat.constants import Compression
    from strawboat.exec import Query, col, load_resident

    n = int(os.environ.get("SB_RES_Q1_ROWS", 6_000_000))
    cols = [
        "l_returnflag", "l_linestatus", "l_quantity", "l_extendedprice",
        "l_discount", "l_tax", "l_shipdate",
    ]
    table = generate_lineitem(scale=1.0, rows=n).select(cols)
    path = os.path.join(tmpdir, "res_q1.str")
    write_file(path, table, options=WriteOptions(
        default_compression=Compression.LZ4,
        default_compress_ratio=1.0,
        max_page_size=65536,
    ))
    read_table(path)  # warm the page cache
    l_read, l_load = [], []
    rt = None
    for _ in range(3):
        l_read.append(_timed(lambda: read_table(path)))
        t0 = time.perf_counter()
        rt = load_resident(path)
        l_load.append(time.perf_counter() - t0)
    emit("resident_load_s", min(l_load), "s", 2.0 * min(l_read) / min(l_load),
         read_table_s=min(l_read), rows=n,
         note="vs_baseline = 2*read/load (>=1.0: load within 2x of the host "
         "read it feeds from)")
    plane_bytes = sum(
        sum(int(w.size) * 4 for w, _b in c.planes) for c in rt.columns.values()
    )
    q = (
        Query(rt)
        .filter(col("l_shipdate") <= EPOCH_DAYS - Q1_DEFAULT_DELTA)
        .group_by("l_returnflag", "l_linestatus", num_groups=16)
        .agg(**_q1_aggs())
    )
    res = q.run()
    want = q1_numpy_reference(table)
    for i in range(int(res["n_groups"])):
        key = tuple(
            res[f"dict_{k}"][int(res[f"key_{k}"][i])].as_py()
            for k in ("l_returnflag", "l_linestatus")
        )
        if int(res["sum_charge"][i]) != want[key]["sum_charge"]:
            raise RuntimeError("resident Q1 disagrees with the reference")
    t_q1 = _best(q.run, 4)
    t_np = _best(lambda: q1_numpy_reference(table), 1)
    emit("resident_q1_latency_ms", t_q1 * 1e3, "ms", t_np / t_q1, rows=n,
         plane_bytes=plane_bytes,
         note="full Q1 (8 aggs, utf8 keys, date filter) over resident planes, "
         "one fused jit, exact vs numpy")


def main() -> int:
    import strawboat.kernels  # noqa: F401  (x64 and the compile cache)

    device_header()
    with tempfile.TemporaryDirectory(prefix="sb_bench_") as tmpdir:
        bench_e2e_scan(tmpdir)
        bench_tpch(tmpdir)
        headline = bench_resident_scan()
        bench_resident_q1(tmpdir)
    emit(**headline)
    return 0


if __name__ == "__main__":
    sys.exit(main())
