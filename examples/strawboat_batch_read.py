#!/usr/bin/env python
"""Batch (all-pages-at-once) read + timing (reference strawboat_batch_read.rs)."""

import sys
import time

sys.path.insert(0, ".")

from strawboat.api import read_table


def main() -> int:
    path = sys.argv[1] if len(sys.argv) > 1 else "/tmp/input.str"
    t0 = time.perf_counter()
    table = read_table(path)
    print(f"read {table.num_rows} rows, cost {(time.perf_counter() - t0) * 1e3:.0f}ms")
    return 0


if __name__ == "__main__":
    sys.exit(main())
