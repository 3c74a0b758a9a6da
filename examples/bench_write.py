#!/usr/bin/env python
"""Write-throughput benchmark vs parquet (reference benches/write_strawboat.rs
+ write_parquet.rs: bool/utf8/i64 arrays at 2^10..2^20 rows, LZ4, page 8192)."""

import io
import sys
import time

sys.path.insert(0, ".")

import numpy as np
import pyarrow as pa
import pyarrow.parquet as pq

from strawboat.codecs import WriteOptions
from strawboat.constants import Compression
from strawboat.write.writer import NativeWriter


def make_table(log2_size: int) -> pa.Table:
    n = 1 << log2_size
    rng = np.random.default_rng(0)
    return pa.table(
        {
            "i64": pa.array(rng.integers(0, 1 << 40, n).astype(np.int64)),
            "utf8": pa.array([f"value-{i % 100}" for i in range(n)]),
            "bool": pa.array(rng.random(n) > 0.5),
        }
    )


def bench_strawboat(table: pa.Table, iters: int = 3) -> float:
    opts = WriteOptions(
        default_compression=Compression.LZ4, max_page_size=8192, sample_seed=0
    )
    best = float("inf")
    for _ in range(iters):
        buf = io.BytesIO()
        t0 = time.perf_counter()
        w = NativeWriter(buf, table.schema, opts)
        w.start()
        w.write(table)
        w.finish()
        best = min(best, time.perf_counter() - t0)
    return best


def bench_parquet(table: pa.Table, iters: int = 3) -> float:
    best = float("inf")
    for _ in range(iters):
        buf = io.BytesIO()
        t0 = time.perf_counter()
        pq.write_table(table, buf, compression="lz4", use_dictionary=False)
        best = min(best, time.perf_counter() - t0)
    return best


def main() -> int:
    print(f"{'rows':>10} {'strawboat ms':>14} {'parquet ms':>12} {'ratio':>7}")
    for lg in (10, 14, 17, 20):
        table = make_table(lg)
        ts = bench_strawboat(table)
        tp = bench_parquet(table)
        print(f"{1 << lg:>10} {ts * 1e3:>14.1f} {tp * 1e3:>12.1f} {tp / ts:>7.2f}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
