"""Deeper nested device layouts (VERDICT item 8): list<list<numeric>>,
list<struct<...>>, map, fixed-size list, list<utf8> — stacked offsets reach
HBM and to_arrow rebuilds the exact nested array.  Ref: the reference
batch-reads all of these (/root/reference/src/read/batch_read.rs:66-187)."""

import numpy as np
import pyarrow as pa
import pytest

from strawboat.api import write_file
from strawboat.codecs import WriteOptions
from strawboat.constants import Compression
from strawboat.exec import scan_file
from strawboat.exec.aggregate import list_segment_sum


def _write(path, table, page=256):
    write_file(
        path,
        table,
        options=WriteOptions(
            default_compression=Compression.LZ4, max_page_size=page
        ),
    )


def _ragged(rng, n, inner):
    out = []
    for _ in range(n):
        k = int(rng.integers(0, 5))
        out.append(inner(k))
    return out


def test_list_of_list_int(tmp_path):
    rng = np.random.default_rng(0)
    data = _ragged(
        rng,
        800,
        lambda k: [
            [int(x) for x in rng.integers(0, 100, int(rng.integers(0, 4)))]
            for _ in range(k)
        ],
    )
    table = pa.table({"ll": pa.array(data, pa.list_(pa.list_(pa.int64())))})
    path = str(tmp_path / "ll.str")
    _write(path, table)
    dt = scan_file(path)
    c = dt["ll"]
    assert c.offsets_stack is not None and len(c.offsets_stack) == 2
    got = dt.to_arrow().column("ll").to_pylist()
    assert got == data


def test_list_of_list_composed_segment_sum(tmp_path):
    """Two-level stacked offsets compose to row→leaf offsets usable by
    list_segment_sum on device."""
    data = [[[1, 2], [3]], [], [[4, 5, 6]], [[], [7]]]
    table = pa.table({"ll": pa.array(data, pa.list_(pa.list_(pa.int64())))})
    path = str(tmp_path / "ll2.str")
    _write(path, table)
    c = scan_file(path)["ll"]
    sums = np.asarray(list_segment_sum(c.values, c.offsets, len(c)))
    assert sums.tolist() == [6, 0, 15, 7]


def test_list_of_struct(tmp_path):
    rng = np.random.default_rng(1)
    data = _ragged(
        rng,
        600,
        lambda k: [
            {"a": int(rng.integers(0, 50)), "b": float(rng.random())}
            for _ in range(k)
        ],
    )
    typ = pa.list_(pa.struct([("a", pa.int64()), ("b", pa.float64())]))
    table = pa.table({"ls": pa.array(data, typ)})
    path = str(tmp_path / "ls.str")
    _write(path, table)
    dt = scan_file(path)
    # struct fields fan out, sharing the row offsets
    ca, cb = dt["ls.a"], dt["ls.b"]
    assert np.array_equal(np.asarray(ca.offsets), np.asarray(cb.offsets))
    flat_a = [d["a"] for row in data for d in row]
    assert np.asarray(ca.values).tolist() == flat_a
    sums = np.asarray(list_segment_sum(ca.values, ca.offsets, len(ca)))
    assert sums.tolist() == [sum(d["a"] for d in row) for row in data]


def test_map_column(tmp_path):
    rng = np.random.default_rng(2)
    data = _ragged(
        rng,
        400,
        lambda k: [
            (int(i), float(rng.random())) for i in range(k)
        ],
    )
    table = pa.table({"m": pa.array(data, pa.map_(pa.int64(), pa.float64()))})
    path = str(tmp_path / "m.str")
    _write(path, table)
    dt = scan_file(path)
    ck, cv = dt["m.key"], dt["m.value"]
    flat_k = [k for row in data for (k, _v) in row]
    flat_v = [v for row in data for (_k, v) in row]
    assert np.asarray(ck.values).tolist() == flat_k
    assert np.allclose(np.asarray(cv.values), flat_v)
    assert np.array_equal(np.asarray(ck.offsets), np.asarray(cv.offsets))


def test_fixed_size_list(tmp_path):
    rng = np.random.default_rng(3)
    n = 300
    data = [[int(x) for x in rng.integers(0, 9, 3)] for _ in range(n)]
    table = pa.table({"f": pa.array(data, pa.list_(pa.int64(), 3))})
    path = str(tmp_path / "f.str")
    _write(path, table)
    dt = scan_file(path)
    c = dt["f"]
    assert np.asarray(c.values).reshape(n, 3).tolist() == data
    assert np.asarray(c.offsets).tolist() == (np.arange(n + 1) * 3).tolist()


def test_list_of_string_dict_codes(tmp_path):
    rng = np.random.default_rng(4)
    words = ["ab", "cd", "ef", "gh"]
    data = _ragged(
        rng, 500, lambda k: [words[int(rng.integers(0, 4))] for _ in range(k)]
    )
    table = pa.table({"ls": pa.array(data, pa.list_(pa.string()))})
    path = str(tmp_path / "lstr.str")
    _write(path, table)
    dt = scan_file(path)
    c = dt["ls"]
    assert c.dictionary is not None  # strings ride as codes
    got = dt.to_arrow().column("ls").to_pylist()
    assert got == data


def test_nullable_list_of_list_roundtrip(tmp_path):
    data = [[[1, None], None, [2]], None, [], [[], [None, 3]]]
    table = pa.table({"ll": pa.array(data, pa.list_(pa.list_(pa.int64())))})
    path = str(tmp_path / "lln.str")
    _write(path, table)
    got = scan_file(path).to_arrow().column("ll").to_pylist()
    assert got == data
