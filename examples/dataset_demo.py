#!/usr/bin/env python
"""Dataset layer demo: partitioned write → pruned multi-file scan → query.

The multi-file production pattern on top of the single-file format (the
reference library is single-file; its consumer stacks exactly this on top):
  1. write_dataset splits a table into standalone part files (each with its
     own footer + in-band zone block)
  2. scan_dataset prunes whole files footer-only, then pages, then scans
  3. Query() runs filter/group-by straight over the glob
"""
import os
import sys
import tempfile
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))


def main():
    import numpy as np
    import pyarrow as pa

    from strawboat.codecs import WriteOptions
    from strawboat.constants import Compression
    from strawboat.exec import Query, col, scan_dataset
    from strawboat.exec.dataset import file_may_match, write_dataset
    from strawboat.exec.pruning import Comparison

    n = int(os.environ.get("SB_DEMO_ROWS", 300_000))
    rng = np.random.default_rng(0)
    table = pa.table(
        {
            "ts": pa.array(np.sort(rng.integers(0, 10_000, n)).astype(np.int64)),
            "region": pa.array(
                np.array(["emea", "apac", "amer"])[rng.integers(0, 3, n)].tolist()
            ),
            "value": pa.array(rng.integers(0, 10**6, n).astype(np.int64)),
        }
    )

    with tempfile.TemporaryDirectory(prefix="sb_dataset_") as d:
        t0 = time.perf_counter()
        paths = write_dataset(
            d,
            table,
            rows_per_file=max(n // 8, 1),
            options=WriteOptions(
                default_compression=Compression.LZ4,
                default_compress_ratio=1.0,
                max_page_size=8192,
                zone_maps=True,
            ),
        )
        print(f"wrote {len(paths)} parts in {time.perf_counter()-t0:.2f}s")

        # ts is globally sorted → each part owns a time band; a narrow time
        # predicate prunes most parts without reading their data pages
        preds = [Comparison("ts", "ge", 4000), Comparison("ts", "lt", 4500)]
        alive = [p for p in paths if file_may_match(p, preds)]
        print(f"file-level pruning: {len(alive)}/{len(paths)} parts survive")

        t0 = time.perf_counter()
        dt = scan_dataset(paths, predicates=preds)
        print(
            f"pruned scan: {dt.num_rows} rows in {time.perf_counter()-t0:.2f}s"
        )

        res = (
            Query(os.path.join(d, "part-*.str"))
            .filter((col("ts") >= 4000) & (col("ts") < 4500))
            .group_by("region", num_groups=16)
            .agg(total=("sum", "value"), cnt=("count", "value"))
            .run()
        )
        ngroups = int(res["n_groups"])
        d_region = res["dict_region"]
        codes = np.asarray(res["key_region"])[:ngroups]
        for i in range(ngroups):
            name = d_region[int(codes[i])].as_py()
            name = name.decode() if isinstance(name, bytes) else name
            print(
                f"  {name}: total={int(np.asarray(res['total'])[i])} "
                f"cnt={int(np.asarray(res['cnt'])[i])}"
            )


if __name__ == "__main__":
    main()
