"""Property-based roundtrip fuzzing: random schemas × random data × codecs.

Broadens the io.rs-style matrix to arbitrary nested type combinations with
random null densities, page sizes, and codec-forcing — all seeded.
"""

import random

import numpy as np
import pyarrow as pa
import pytest

from strawboat.api import iter_batches, read_table, write_file
from strawboat.codecs import WriteOptions
from strawboat.constants import Compression

PRIMS = [
    pa.int8(),
    pa.int16(),
    pa.int32(),
    pa.int64(),
    pa.uint8(),
    pa.uint32(),
    pa.uint64(),
    pa.float32(),
    pa.float64(),
    pa.bool_(),
    pa.string(),
    pa.binary(),
    pa.large_string(),
    pa.date32(),
    pa.timestamp("us"),
]


def rand_type(r: random.Random, depth: int) -> pa.DataType:
    if depth <= 0 or r.random() < 0.55:
        return r.choice(PRIMS)
    kind = r.choice(["list", "large_list", "struct", "map", "fsl"])
    if kind == "list":
        return pa.list_(rand_type(r, depth - 1))
    if kind == "large_list":
        return pa.large_list(rand_type(r, depth - 1))
    if kind == "fsl":
        return pa.list_(rand_type(r, depth - 1), r.randint(1, 3))
    if kind == "map":
        return pa.map_(r.choice([pa.string(), pa.int64()]), rand_type(r, depth - 1))
    n = r.randint(1, 3)
    return pa.struct([(f"f{i}", rand_type(r, depth - 1)) for i in range(n)])


def rand_value(r: random.Random, t: pa.DataType, null_p: float):
    if r.random() < null_p:
        return None
    if pa.types.is_boolean(t):
        return r.random() < 0.5
    if pa.types.is_integer(t):
        info = (0, 200) if "uint" in str(t) else (-100, 100)
        return r.randint(*info)
    if pa.types.is_floating(t):
        return round(r.gauss(0, 100), 3)
    if pa.types.is_string(t) or pa.types.is_large_string(t):
        return f"s{r.randint(0, 30)}"
    if pa.types.is_binary(t):
        return bytes([r.randint(0, 255) for _ in range(r.randint(0, 6))])
    if pa.types.is_date(t):
        return r.randint(0, 20000)
    if pa.types.is_timestamp(t):
        return r.randint(0, 10**12)
    if pa.types.is_list(t) or pa.types.is_large_list(t):
        if pa.types.is_fixed_size_list(t):
            return [rand_value(r, t.value_type, null_p) for _ in range(t.list_size)]
        return [rand_value(r, t.value_type, null_p) for _ in range(r.randint(0, 4))]
    if pa.types.is_fixed_size_list(t):
        return [rand_value(r, t.value_type, null_p) for _ in range(t.list_size)]
    if pa.types.is_map(t):
        n = r.randint(0, 3)
        keys = set()
        out = []
        for _ in range(n):
            k = rand_value(r, t.key_type, 0.0)
            if k in keys:
                continue
            keys.add(k)
            out.append((k, rand_value(r, t.item_type, null_p)))
        return out
    if pa.types.is_struct(t):
        return {f.name: rand_value(r, f.type, null_p) for f in t}
    raise NotImplementedError(str(t))


@pytest.mark.parametrize("seed", range(30))
def test_fuzz_roundtrip(tmp_path, seed):
    r = random.Random(1000 + seed)
    n_cols = r.randint(1, 4)
    n_rows = r.choice([1, 7, 100, 1000, 2049])
    null_p = r.choice([0.0, 0.1, 0.5])
    fields = []
    arrays = []
    for ci in range(n_cols):
        t = rand_type(r, depth=2)
        vals = [rand_value(r, t, null_p) for _ in range(n_rows)]
        arr = pa.array(vals, type=t)
        fields.append(pa.field(f"c{ci}", t))
        arrays.append(arr)
    table = pa.table(dict(zip([f.name for f in fields], arrays)))
    opts = WriteOptions(
        default_compression=r.choice(
            [Compression.LZ4, Compression.ZSTD, Compression.SNAPPY, Compression.NONE]
        ),
        default_compress_ratio=r.choice([None, 1.0, 2.0]),
        max_page_size=r.choice([64, 333, 1024, None]),
        sample_seed=seed,
    )
    path = str(tmp_path / f"f{seed}.str")
    write_file(path, table, options=opts)
    got = read_table(path)
    assert got.to_pylist() == table.to_pylist(), f"seed {seed} batch mismatch"
    got2 = pa.Table.from_batches(list(iter_batches(path)), schema=table.schema)
    assert got2.to_pylist() == table.to_pylist(), f"seed {seed} stream mismatch"


def test_null_struct_over_list_compaction(tmp_path):
    """Leaf slots under null structs: struct chains re-insert, lists don't
    (the frozen-traversal rule in write_levels)."""
    t = pa.struct(
        [
            ("f0", pa.list_(pa.struct([("a", pa.uint32()), ("b", pa.float64())]), 3)),
            ("f1", pa.large_list(pa.int8())),
        ]
    )
    r = random.Random(3)
    from test_fuzz import rand_value as rv  # self-import safe under pytest

    vals = [rand_value(r, t, 0.5) for _ in range(500)]
    table = pa.table({"c": pa.array(vals, type=t)})
    path = str(tmp_path / "nsl.str")
    write_file(path, table, options=WriteOptions(max_page_size=128))
    got = read_table(path)
    assert got.to_pylist() == table.to_pylist()


@pytest.mark.parametrize("seed", range(30, 60))
def test_fuzz_deep(tmp_path, seed):
    """Depth-3 high-null fuzz (the regime that exposed FSL/null-struct bugs)."""
    r = random.Random(5000 + seed)
    n_cols = r.randint(1, 4)
    n_rows = r.choice([1, 7, 100, 1000, 2049])
    null_p = r.choice([0.0, 0.1, 0.5, 0.95])
    arrays = {}
    for ci in range(n_cols):
        t = rand_type(r, depth=3)
        arrays[f"c{ci}"] = pa.array(
            [rand_value(r, t, null_p) for _ in range(n_rows)], type=t
        )
    table = pa.table(arrays)
    opts = WriteOptions(
        default_compression=r.choice(
            [Compression.LZ4, Compression.ZSTD, Compression.SNAPPY, Compression.NONE]
        ),
        default_compress_ratio=r.choice([None, 1.0]),
        max_page_size=r.choice([64, 333, 1024, None]),
        sample_seed=seed,
    )
    path = str(tmp_path / f"d{seed}.str")
    write_file(path, table, options=opts)
    got = read_table(path)
    assert got.to_pylist() == table.to_pylist()
