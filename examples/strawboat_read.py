#!/usr/bin/env python
"""Streaming full-file read + timing (reference examples/strawboat_read.rs)."""

import sys
import time

sys.path.insert(0, ".")

from strawboat.api import iter_batches


def main() -> int:
    path = sys.argv[1] if len(sys.argv) > 1 else "/tmp/input.str"
    t0 = time.perf_counter()
    rows = 0
    for batch in iter_batches(path):
        rows += batch.num_rows
    print(f"read {rows} rows, cost {(time.perf_counter() - t0) * 1e3:.0f}ms")
    return 0


if __name__ == "__main__":
    sys.exit(main())
