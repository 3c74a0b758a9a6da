#!/usr/bin/env python
"""TPC-H Q1/Q6 end-to-end benchmark (BASELINE config 4 shape).

Generates lineitem at the given scale, writes it as strawboat with zone maps,
then times: device scan (with and without pruning), Q6, Q1.

Usage: python examples/tpch_bench.py [scale=0.1]
"""

import sys
import time

sys.path.insert(0, ".")


def main() -> int:
    scale = float(sys.argv[1]) if len(sys.argv) > 1 else 0.1
    import numpy as np

    from strawboat.api import write_file
    from strawboat.benchsuite.tpch import (
        generate_lineitem,
        q1,
        q6,
        q6_numpy_reference,
        q6_pruning_predicates,
    )
    from strawboat.codecs import WriteOptions
    from strawboat.constants import Compression
    from strawboat.exec import scan_file

    t0 = time.perf_counter()
    table = generate_lineitem(scale)
    print(f"gen lineitem sf={scale}: {table.num_rows} rows "
          f"({time.perf_counter() - t0:.1f}s)")

    path = "/tmp/lineitem.str"
    t0 = time.perf_counter()
    write_file(
        path,
        table,
        options=WriteOptions(
            default_compression=Compression.LZ4,
            default_compress_ratio=1.0,
            max_page_size=65536,
            sample_seed=0,
            zone_maps=True,
        ),
    )
    dt = time.perf_counter() - t0
    import os

    size = os.path.getsize(path)
    print(f"write: {dt:.2f}s ({table.num_rows / dt / 1e6:.1f} Mrows/s, "
          f"{size / 1e6:.0f} MB on disk)")

    t0 = time.perf_counter()
    full = scan_file(path)
    print(f"device scan (cold, incl. compiles): {time.perf_counter() - t0:.2f}s")
    t0 = time.perf_counter()
    full = scan_file(path)
    dt = time.perf_counter() - t0
    print(
        f"device scan (warm): {dt:.3f}s "
        f"({table.num_rows / dt / 1e6:.1f} Mrows/s, {size / dt / 1e6:.0f} MB/s compressed)"
    )

    t0 = time.perf_counter()
    pruned = scan_file(path, predicates=q6_pruning_predicates())
    print(
        f"device scan (Q6-pruned): {time.perf_counter() - t0:.2f}s "
        f"({len(pruned['l_shipdate'])}/{table.num_rows} rows decoded)"
    )

    # Q6 on the pruned scan
    t0 = time.perf_counter()
    rev = int(q6(pruned))
    t_q6 = time.perf_counter() - t0
    assert rev == q6_numpy_reference(table)
    print(f"Q6: {t_q6 * 1e3:.0f} ms (first incl. compile), revenue={rev}")
    t0 = time.perf_counter()
    int(q6(pruned))
    print(f"Q6 warm: {(time.perf_counter() - t0) * 1e3:.0f} ms")

    t0 = time.perf_counter()
    res = q1(full)  # arrow table ordered by (returnflag, linestatus)
    n_groups = res.num_rows
    t_q1 = time.perf_counter() - t0
    print(f"Q1: {t_q1 * 1e3:.0f} ms (first incl. compile), {n_groups} groups")
    t0 = time.perf_counter()
    q1(full)
    print(f"Q1 warm: {(time.perf_counter() - t0) * 1e3:.0f} ms")
    return 0


if __name__ == "__main__":
    sys.exit(main())
