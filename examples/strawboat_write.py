#!/usr/bin/env python
"""Parquet → strawboat converter (reference examples/strawboat_write.rs:27-112).

Usage: python examples/strawboat_write.py <input.parquet> [output.str]
Writes the strawboat file plus a JSON dump of the column metas (the
external-catalog export path, strawboat_write.rs:45-52).
"""

import json
import sys
import time

sys.path.insert(0, ".")

import pyarrow.parquet as pq

from strawboat.api import write_file
from strawboat.codecs import WriteOptions
from strawboat.constants import Compression


def main() -> int:
    src = sys.argv[1]
    dst = sys.argv[2] if len(sys.argv) > 2 else "/tmp/input.str"
    table = pq.read_table(src)
    t0 = time.perf_counter()
    metas = write_file(
        dst,
        table,
        options=WriteOptions(
            default_compression=Compression.LZ4,
            default_compress_ratio=1.0,
            max_page_size=8192,
        ),
    )
    dt = (time.perf_counter() - t0) * 1e3
    meta_doc = [
        {"offset": m.offset, "pages": [[p.length, p.num_values] for p in m.pages]}
        for m in metas
    ]
    with open(dst + ".meta.json", "w") as f:
        json.dump(meta_doc, f)
    print(f"wrote {dst} ({table.num_rows} rows) cost {dt:.0f}ms")
    return 0


if __name__ == "__main__":
    sys.exit(main())
