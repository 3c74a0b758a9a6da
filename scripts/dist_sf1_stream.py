#!/usr/bin/env python
"""Config-5-shaped run at SF1 on the virtual 8-device mesh.

TPC-H lineitem SF1 (6M rows) written as a 12-part dataset, streamed through
the pipelined distributed aggregate (chunked decode overlapping the keyed
all_to_all exchange) — the same code four GPUs run over NVLink; here the mesh is
8 virtual CPU devices, so the numbers are correctness/shape evidence, not
chip performance.  Verifies group totals exactly against numpy.
"""
import os
import sys
import time

# virtual mesh BEFORE jax init
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = flags + " --xla_force_host_platform_device_count=8"
os.environ["JAX_PLATFORMS"] = "cpu"

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import numpy as np


def main():
    import jax

    jax.config.update("jax_platforms", "cpu")

    from strawboat.benchsuite.tpch import generate_lineitem
    from strawboat.codecs import WriteOptions
    from strawboat.constants import Compression
    from strawboat.exec.dataset import write_dataset
    from strawboat.parallel import make_mesh
    from strawboat.parallel.pipeline import streamed_dataset_aggregate

    n = int(os.environ.get("SB_ROWS", 6_000_000))
    t0 = time.perf_counter()
    table = generate_lineitem(scale=1.0, rows=n)
    print(f"gen {n} rows: {time.perf_counter()-t0:.1f}s", flush=True)

    import tempfile

    with tempfile.TemporaryDirectory(prefix="sb_sf1_ds_") as d:
        t0 = time.perf_counter()
        paths = write_dataset(
            d,
            table.select(["l_quantity", "l_extendedprice", "l_discount", "l_tax"]),
            rows_per_file=n // 12 + 1,
            options=WriteOptions(
                default_compression=Compression.LZ4,
                default_compress_ratio=1.0,
                max_page_size=65536,
                zone_maps=True,
            ),
        )
        print(f"wrote {len(paths)} parts: {time.perf_counter()-t0:.1f}s", flush=True)

        mesh = make_mesh(8)
        t0 = time.perf_counter()
        res = streamed_dataset_aggregate(
            mesh,
            "shards",
            paths,
            key="l_quantity",  # dense 1..50 — a 50-group keyed aggregate
            aggs={
                "sum_price": ("sum", "l_extendedprice"),
                "sum_disc": ("sum", "l_discount"),
                "cnt": ("count", "l_extendedprice"),
            },
            chunk_pages=16,
            num_groups=128,
        )
        ok = np.asarray(res["valid"])
        dt = time.perf_counter() - t0
        got = dict(
            zip(
                np.asarray(res["keys"])[ok].tolist(),
                np.asarray(res["sum_price"])[ok].tolist(),
            )
        )
    qty = table.column("l_quantity").to_numpy()
    ep = table.column("l_extendedprice").to_numpy()
    exp = {int(q): int(ep[qty == q].sum()) for q in np.unique(qty)}
    assert got == exp, "distributed stream aggregate mismatch"
    print(
        f"streamed distributed aggregate over {len(paths)} parts / 8 shards: "
        f"{dt:.1f}s = {n/dt/1e6:.2f} Mrows/s (virtual CPU mesh), "
        f"{int(ok.sum())} groups exact vs numpy",
        flush=True,
    )


if __name__ == "__main__":
    main()
