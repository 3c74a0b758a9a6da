"""Integration roundtrip tests: codec × read-path matrix.

Mirrors the reference's tests/it/io.rs: seeded random chunks with controlled
null density and cardinality, write→read equality over every common
compression × both read paths (streaming ``iter_batches`` and batch
``read_table``), with cases targeting each structured codec by data shape
(io.rs:104-278), page size 2048.
"""

import numpy as np
import pyarrow as pa
import pytest

from conftest import (
    PAGE_SIZE,
    create_random_bool,
    create_random_double,
    create_random_i64,
    create_random_index,
    create_random_string,
    rng,
)
from strawboat.api import iter_batches, read_table, write_file
from strawboat.codecs import WriteOptions
from strawboat.constants import Compression

COMMONS = [
    Compression.LZ4,
    Compression.ZSTD,
    Compression.SNAPPY,
    Compression.NONE,
]


def roundtrip(table: pa.Table, path: str, compression: Compression, ratio=1.0):
    opts = WriteOptions(
        default_compression=compression,
        default_compress_ratio=ratio,
        max_page_size=PAGE_SIZE,
    )
    write_file(path, table, options=opts)
    got_batch = read_table(path)
    assert got_batch.to_pylist() == table.to_pylist(), "batch read mismatch"
    got_stream = pa.Table.from_batches(list(iter_batches(path)), schema=table.schema)
    assert got_stream.to_pylist() == table.to_pylist(), "stream read mismatch"


@pytest.mark.parametrize("compression", COMMONS)
@pytest.mark.parametrize("size", [PAGE_SIZE, PAGE_SIZE + 10, PAGE_SIZE * 2 + 5])
def test_basic_mixed(tmp_strawboat, compression, size):
    table = pa.table(
        {
            "int32": create_random_index(size, 0.2, 100),
            "int64": create_random_i64(size, 0.0),
            "f64": create_random_double(size, 0.1),
            "bool": create_random_bool(size, 0.3),
            "utf8": create_random_string(size, 0.2, 50),
        }
    )
    roundtrip(table, tmp_strawboat, compression)


def test_dict(tmp_strawboat):
    # low cardinality → Dict (io.rs:104)
    table = pa.table({"c": create_random_index(PAGE_SIZE * 2, 0.1, 8)})
    roundtrip(table, tmp_strawboat, Compression.LZ4)


def test_freq(tmp_strawboat):
    # 90%-dominant value (io.rs:119)
    r = rng()
    vals = np.full(PAGE_SIZE * 2, 1000, dtype=np.int64)
    idx = r.integers(0, len(vals), len(vals) // 20)
    vals[idx] = r.integers(0, 1 << 40, len(idx))
    table = pa.table({"c": pa.array(vals)})
    roundtrip(table, tmp_strawboat, Compression.LZ4)


def test_bitpacking(tmp_strawboat):
    r = rng()
    vals = r.integers(0, 1 << 12, PAGE_SIZE * 2, dtype=np.int32)
    table = pa.table({"c": pa.array(vals)})
    roundtrip(table, tmp_strawboat, Compression.LZ4)


def test_delta_bitpacking(tmp_strawboat):
    r = rng()
    vals = np.sort(r.integers(0, 1 << 20, PAGE_SIZE * 2).astype(np.uint32))
    table = pa.table({"c": pa.array(vals, type=pa.uint32())})
    roundtrip(table, tmp_strawboat, Compression.LZ4)


def test_onevalue(tmp_strawboat):
    table = pa.table(
        {
            "i": pa.array(np.full(PAGE_SIZE, 7, dtype=np.int64)),
            "s": pa.array(["x"] * PAGE_SIZE),
            "b": pa.array([True] * PAGE_SIZE),
        }
    )
    roundtrip(table, tmp_strawboat, Compression.LZ4)


def test_patas(tmp_strawboat):
    r = rng()
    table = pa.table({"f": pa.array(np.cumsum(r.normal(0, 1, PAGE_SIZE * 2)))})
    roundtrip(table, tmp_strawboat, Compression.LZ4)


def test_boolean_rle(tmp_strawboat):
    r = rng()
    vals = np.repeat(r.random(PAGE_SIZE // 64) > 0.5, 128)
    table = pa.table({"b": pa.array(vals)})
    roundtrip(table, tmp_strawboat, Compression.LZ4)


# ---------------------------------------------------------------------------
# nesting (io.rs:167-278)


def _nested_table(size: int):
    r = rng()

    def maybe(i, v, mod=7):
        return v if i % mod else None

    return pa.table(
        {
            "struct": pa.array(
                [
                    maybe(i, {"a": int(r.integers(0, 100)), "b": f"s{i % 9}"}, 6)
                    for i in range(size)
                ],
                type=pa.struct([("a", pa.int64()), ("b", pa.string())]),
            ),
            "list": pa.array(
                [
                    maybe(i, [int(x) for x in r.integers(0, 100, i % 5)])
                    for i in range(size)
                ],
                type=pa.list_(pa.int64()),
            ),
            "large_list": pa.array(
                [maybe(i, [float(i), None]) for i in range(size)],
                type=pa.large_list(pa.float64()),
            ),
            "list_list": pa.array(
                [
                    maybe(i, [[1, 2], None, []] if i % 3 else [[i]])
                    for i in range(size)
                ],
                type=pa.list_(pa.list_(pa.int32())),
            ),
            "list_struct": pa.array(
                [maybe(i, [{"x": i}, None] if i % 2 else []) for i in range(size)],
                type=pa.list_(pa.struct([("x", pa.int64())])),
            ),
            "map": pa.array(
                [maybe(i, [(f"k{i % 5}", i), (f"q{i % 3}", None)]) for i in range(size)],
                type=pa.map_(pa.string(), pa.int64()),
            ),
            "list_map": pa.array(
                [maybe(i, [[(f"k{i % 4}", i)], None] if i % 2 else []) for i in range(size)],
                type=pa.list_(pa.map_(pa.string(), pa.int64())),
            ),
            "struct_list": pa.array(
                [
                    maybe(i, {"l": [i, i + 1] if i % 3 else None}, 5)
                    for i in range(size)
                ],
                type=pa.struct([("l", pa.list_(pa.int64()))]),
            ),
        }
    )


@pytest.mark.parametrize("compression", COMMONS)
def test_nested(tmp_strawboat, compression):
    roundtrip(_nested_table(PAGE_SIZE + 77), tmp_strawboat, compression)


def test_nested_multi_page(tmp_strawboat):
    roundtrip(_nested_table(PAGE_SIZE * 3 + 5), tmp_strawboat, Compression.LZ4)


def test_page_slicing_offsets(tmp_strawboat):
    # page boundaries cut through list runs
    r = rng()
    size = PAGE_SIZE * 2 + 333
    table = pa.table(
        {
            "l": pa.array(
                [
                    [int(x) for x in r.integers(0, 1000, int(r.integers(0, 9)))]
                    if r.random() > 0.15
                    else None
                    for _ in range(size)
                ],
                type=pa.list_(pa.int64()),
            )
        }
    )
    roundtrip(table, tmp_strawboat, Compression.ZSTD)


def test_empty_and_single_row(tmp_strawboat):
    table = pa.table({"a": pa.array([1], type=pa.int64()), "s": pa.array(["x"])})
    roundtrip(table, tmp_strawboat, Compression.LZ4)


def test_fixed_size_list(tmp_strawboat):
    size = PAGE_SIZE + 3
    table = pa.table(
        {
            "fsl": pa.array(
                [[i, i + 1] if i % 4 else None for i in range(size)],
                type=pa.list_(pa.int32(), 2),
            )
        }
    )
    roundtrip(table, tmp_strawboat, Compression.LZ4)


def test_non_nullable_fields(tmp_strawboat):
    schema = pa.schema(
        [
            pa.field("a", pa.int64(), nullable=False),
            pa.field(
                "l",
                pa.list_(pa.field("item", pa.int32(), nullable=False)),
                nullable=False,
            ),
        ]
    )
    table = pa.table(
        {
            "a": pa.array(range(PAGE_SIZE + 9), type=pa.int64()),
            "l": pa.array(
                [[i, i + 1] if i % 2 else [] for i in range(PAGE_SIZE + 9)],
                type=schema.field("l").type,
            ),
        },
        schema=schema,
    )
    roundtrip(table, tmp_strawboat, Compression.LZ4)


def test_zero_row_table(tmp_strawboat):
    table = pa.table(
        {
            "a": pa.array([], type=pa.int64()),
            "s": pa.array([], type=pa.string()),
            "l": pa.array([], type=pa.list_(pa.int32())),
        }
    )
    roundtrip(table, tmp_strawboat, Compression.LZ4)


def test_read_arena_recycles_buffers(tmp_strawboat):
    """ReadArena: correct results, buffer reuse, and mixed-file safety.

    Reference parity: PageIterator::swap_buffer buffer recycling
    (/root/reference/src/read/mod.rs:26-57) lifted to the batch read.
    """
    from strawboat.read.fast import ReadArena

    table = pa.table(
        {
            "a": pa.array(create_random_i64(PAGE_SIZE * 3 + 17, 0.0)),
            "f": pa.array(
                np.random.default_rng(7).normal(size=PAGE_SIZE * 3 + 17), type=pa.float64()
            ),
            # string column is fast-path-ineligible: must still read right
            "s": pa.array(create_random_string(PAGE_SIZE * 3 + 17, 0.0, 8)),
        }
    )
    opts = WriteOptions(
        default_compression=Compression.LZ4,
        default_compress_ratio=None,
        max_page_size=PAGE_SIZE,
    )
    write_file(tmp_strawboat, table, options=opts)

    arena = ReadArena()
    fresh = read_table(tmp_strawboat)
    got1 = read_table(tmp_strawboat, arena=arena)
    assert got1.equals(fresh)
    addrs1 = {
        got1.column(c).chunk(0).buffers()[1].address for c in ("a", "f")
    }
    arena_engaged = bool(arena._lent)  # forced-codec CI runs can push every
    # column off the fast path; recycling (and aliasing) only applies there
    got2 = read_table(tmp_strawboat, arena=arena)
    assert got2.equals(fresh)
    if arena_engaged:
        # second read recycled the first read's values buffers (aliasing
        # contract; same-size buffers may swap owners within the arena)
        addrs2 = {
            got2.column(c).chunk(0).buffers()[1].address for c in ("a", "f")
        }
        assert addrs2 == addrs1

    # a different-sized file through the same arena allocates fresh, still right
    small = pa.table({"a": pa.array(create_random_i64(PAGE_SIZE, 0.0))})
    import os

    p2 = tmp_strawboat + ".2"
    write_file(p2, small, options=opts)
    try:
        got3 = read_table(p2, arena=arena)
        assert got3.column("a").to_pylist() == small.column("a").to_pylist()
    finally:
        os.remove(p2)
