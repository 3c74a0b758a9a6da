"""Round-4 correctness tests: silent-wrong-answer classes from VERDICT r3.

1. Masked min/max at EXACT group capacity: masked-out rows are routed to
   segment ``num_groups - 1``; when the real group count exactly fills the
   capacity that segment is a real group, so min/max must neutralize masked
   values (sum/count already did).
"""

import numpy as np

import jax.numpy as jnp

from strawboat.exec.aggregate import hash_aggregate
from strawboat.exec.scan import DeviceColumn, DeviceTable


def _table(cols):
    dcols = {
        name: DeviceColumn(name, None, jnp.asarray(v), validity)
        for name, (v, validity) in cols.items()
    }
    n = len(next(iter(cols.values()))[0])
    return DeviceTable(dcols, n)


def test_masked_min_at_exact_capacity():
    # 4 real groups, capacity exactly 4 → masked rows land IN group 3
    k = np.array([0, 1, 2, 3, 3, 3], dtype=np.int64)
    v = np.array([10, 20, 30, 50, -999, 999], dtype=np.int64)
    mask = jnp.asarray([True, True, True, True, False, False])
    t = _table({"k": (k, None), "v": (v, None)})
    res = hash_aggregate(
        t,
        ["k"],
        {"mn": ("min", "v"), "mx": ("max", "v"), "s": ("sum", "v"),
         "c": ("count", "v")},
        num_groups=4,
        mask=mask,
        on_overflow="raise",
    )
    assert int(res["n_groups"]) == 4
    by_key = {
        int(res["key_k"][i]): (
            int(res["mn"][i]), int(res["mx"][i]), int(res["s"][i]),
            int(res["c"][i]),
        )
        for i in range(4)
    }
    # group 3 must NOT absorb the masked -999/999 rows in any aggregate
    assert by_key[3] == (50, 50, 50, 1)
    assert by_key[0] == (10, 10, 10, 1)


def test_masked_minmax_float_at_exact_capacity():
    k = np.array([0, 1, 1], dtype=np.int64)
    v = np.array([1.5, 2.5, -100.0], dtype=np.float64)
    mask = jnp.asarray([True, True, False])
    t = _table({"k": (k, None), "v": (v, None)})
    res = hash_aggregate(
        t,
        ["k"],
        {"mn": ("min", "v"), "mx": ("max", "v")},
        num_groups=2,
        mask=mask,
        on_overflow="raise",
    )
    assert int(res["n_groups"]) == 2
    by_key = {
        int(res["key_k"][i]): (float(res["mn"][i]), float(res["mx"][i]))
        for i in range(2)
    }
    assert by_key[1] == (2.5, 2.5)


def test_mixed_codec_column_fast_path(tmp_path):
    """A column mixing DICT / BITPACKING / ONE_VALUE / raw pages must decode
    on the planned fast path (not fall back to the per-page reader) and
    match the source exactly."""
    import pyarrow as pa

    from strawboat import native
    from strawboat.api import read_table, write_file
    from strawboat.codecs import WriteOptions
    from strawboat.constants import Compression

    if not native.available():
        import pytest

        pytest.skip("native runtime unavailable")
    rng = np.random.default_rng(0)
    page = 512
    parts = [
        rng.integers(0, 4, page) * 1_000_003,        # DICT page
        np.full(page, 77),                           # ONE_VALUE page
        rng.integers(-(1 << 62), 1 << 62, page),     # raw (LZ4) page
        rng.integers(0, 3, page) * 999_999_999,      # DICT page again
    ]
    v = np.concatenate(parts)
    t = pa.table(
        {"m": pa.array(v)},
        schema=pa.schema([pa.field("m", pa.int64(), nullable=False)]),
    )
    p = str(tmp_path / "mix.str")
    write_file(
        p,
        t,
        options=WriteOptions(
            default_compression=Compression.LZ4,
            default_compress_ratio=1.0,
            max_page_size=page,
        ),
    )
    # confirm the file really has heterogeneous page codecs
    from strawboat.codecs import read_header
    from strawboat.read.reader import read_meta

    with open(p, "rb") as f:
        metas = read_meta(f)
    codecs = set()
    pos = metas[0].offset
    fb = np.memmap(p, dtype=np.uint8, mode="r")
    for pg in metas[0].pages:
        c, _cs, _us, _b = read_header(fb[pos : pos + pg.length], 0)
        codecs.add(c.name)
        pos += pg.length
    assert len(codecs) > 1, f"expected a codec mix, got {codecs}"
    # fast path handles it directly
    from strawboat.read.fast import read_column_fast

    schema = t.schema
    arr = read_column_fast(fb, metas[0], schema.field("m"))
    assert arr is not None, "mixed-codec column fell off the fast path"
    assert arr.to_pylist() == v.tolist()
    # and the public API agrees
    back = read_table(p)
    assert back.column("m").to_pylist() == v.tolist()


def test_bp_int32_column_fast_path(tmp_path):
    """Plain BITPACKING (4-byte) pages decode on the fast path."""
    import pyarrow as pa

    from strawboat import native
    from strawboat.api import read_table, write_file
    from strawboat.codecs import WriteOptions
    from strawboat.constants import Compression

    if not native.available():
        import pytest

        pytest.skip("native runtime unavailable")
    rng = np.random.default_rng(1)
    v = rng.integers(0, 1 << 14, 4096).astype(np.int32)
    t = pa.table(
        {"b": pa.array(v)},
        schema=pa.schema([pa.field("b", pa.int32(), nullable=False)]),
    )
    p = str(tmp_path / "bp.str")
    write_file(
        p,
        t,
        options=WriteOptions(
            default_compression=Compression.LZ4,
            default_compress_ratio=1.0,
            max_page_size=1024,
        ),
    )
    back = read_table(p)
    assert back.column("b").to_pylist() == v.tolist()


def test_raw_string_column_fast_path(tmp_path):
    """High-entropy strings (raw two-block pages) decode on the binary fast
    path and match exactly; nullable variant included."""
    import pyarrow as pa

    from strawboat import native
    from strawboat.api import read_table, write_file
    from strawboat.codecs import WriteOptions
    from strawboat.constants import Compression

    if not native.available():
        import pytest

        pytest.skip("native runtime unavailable")
    rng = np.random.default_rng(5)
    n = 3000
    # unique-ish strings of varying length -> dict never wins -> raw pages
    vals = [f"{rng.integers(0, 1 << 60):x}-{'x' * int(rng.integers(0, 20))}" for _ in range(n)]
    nulls = rng.random(n) < 0.15
    t = pa.table(
        {
            "s": pa.array(vals, pa.string()),
            "sn": pa.array(
                [None if nu else v for v, nu in zip(vals, nulls)], pa.string()
            ),
        },
        schema=pa.schema(
            [
                pa.field("s", pa.string(), nullable=False),
                pa.field("sn", pa.string(), nullable=True),
            ]
        ),
    )
    p = str(tmp_path / "rawstr.str")
    write_file(
        p,
        t,
        options=WriteOptions(
            default_compression=Compression.LZ4,
            default_compress_ratio=1.0,
            max_page_size=512,
        ),
    )
    # prove the fast path handles it directly
    from strawboat.api import split_metas_by_field
    from strawboat.read.fast import read_binary_column_fast
    from strawboat.read.reader import infer_schema, read_meta

    with open(p, "rb") as f:
        schema = infer_schema(f)
        metas = read_meta(f)
    fb = np.memmap(p, dtype=np.uint8, mode="r")
    per_field = split_metas_by_field(schema, metas)
    arr = read_binary_column_fast(fb, per_field[0][0], schema.field("s"))
    assert arr is not None, "raw string column fell off the fast path"
    assert arr.to_pylist() == vals
    back = read_table(p)
    assert back.column("s").to_pylist() == vals
    assert back.column("sn").to_pylist() == [
        None if nu else v for v, nu in zip(vals, nulls)
    ]


def test_onevalue_string_pages_fast_path(tmp_path):
    """String columns whose pages mix ONE_VALUE with raw or DICT stay on
    the binary fast path (SF10: a constant-ish column cost 3 s via the
    general reader)."""
    import pyarrow as pa

    from strawboat import native
    from strawboat.api import read_table, write_file
    from strawboat.codecs import WriteOptions
    from strawboat.constants import Compression

    if not native.available():
        import pytest

        pytest.skip("native runtime unavailable")
    rng = np.random.default_rng(7)
    page = 256
    # col A: OV pages + raw pages
    a_parts = [
        np.repeat("CONSTVAL", page),
        np.array([f"u{rng.integers(0, 1 << 50):x}" for _ in range(page)]),
        np.repeat("OTHERCONST", page),
    ]
    a = np.concatenate(a_parts)
    # col B: OV pages + dict pages
    b_parts = [
        np.repeat("zzz", page),
        np.array(["aa", "bb", "cc"])[rng.integers(0, 3, page)],
        np.repeat("yyy", page),
    ]
    b = np.concatenate(b_parts)
    # col C: all OV
    c = np.repeat("ONLYONE", page * 3)
    t = pa.table(
        {"a": pa.array(a), "b": pa.array(b), "c": pa.array(c)},
        schema=pa.schema(
            [pa.field(n, pa.string(), nullable=False) for n in "abc"]
        ),
    )
    p = str(tmp_path / "ovstr.str")
    write_file(
        p,
        t,
        options=WriteOptions(
            default_compression=Compression.LZ4,
            default_compress_ratio=1.0,
            max_page_size=page,
        ),
    )
    from strawboat.api import split_metas_by_field
    from strawboat.read.fast import read_binary_column_fast
    from strawboat.read.reader import infer_schema, read_meta

    with open(p, "rb") as f:
        schema = infer_schema(f)
        metas = read_meta(f)
    fb = np.memmap(p, dtype=np.uint8, mode="r")
    per_field = split_metas_by_field(schema, metas)
    for i, (name, src) in enumerate([("a", a), ("b", b), ("c", c)]):
        arr = read_binary_column_fast(fb, per_field[i][0], schema.field(name))
        assert arr is not None, f"column {name} fell off the fast path"
        assert arr.to_pylist() == src.tolist(), name
    back = read_table(p)
    for name, src in [("a", a), ("b", b), ("c", c)]:
        assert back.column(name).to_pylist() == src.tolist(), name


def test_freq_string_pages_fast_path(tmp_path):
    """FREQ string pages (90%-dominant value + roaring exceptions) join the
    dict-family fast path — the l_linestatus SF10 shape (OV+FREQ+DICT mix)."""
    import pyarrow as pa

    from strawboat import native
    from strawboat.api import read_table, write_file
    from strawboat.codecs import WriteOptions
    from strawboat.constants import Compression

    if not native.available():
        import pytest

        pytest.skip("native runtime unavailable")
    rng = np.random.default_rng(17)
    page = 256
    parts = []
    # FREQ page: 95% "DOM", rare exceptions
    fv = np.where(rng.random(page) < 0.95, "DOM", "rareX").astype(object)
    parts.append(fv)
    # OV page
    parts.append(np.repeat("CONST", page).astype(object))
    # DICT page
    parts.append(
        np.array(["aa", "bb", "cc"], dtype=object)[rng.integers(0, 3, page)]
    )
    v = np.concatenate(parts)
    t = pa.table(
        {"s": pa.array(list(v), pa.string())},
        schema=pa.schema([pa.field("s", pa.string(), nullable=False)]),
    )
    p = str(tmp_path / "freqstr.str")
    write_file(
        p,
        t,
        options=WriteOptions(
            default_compression=Compression.LZ4,
            default_compress_ratio=1.0,
            max_page_size=page,
        ),
    )
    from strawboat.api import split_metas_by_field
    from strawboat.read.fast import read_binary_column_fast
    from strawboat.read.reader import infer_schema, read_meta
    from strawboat.codecs import read_header
    from strawboat.constants import Compression as C

    with open(p, "rb") as f:
        schema = infer_schema(f)
        metas = read_meta(f)
    fb = np.memmap(p, dtype=np.uint8, mode="r")
    meta = split_metas_by_field(schema, metas)[0][0]
    codecs = set()
    pos = meta.offset
    for pg in meta.pages:
        c, _cs, _us, _b = read_header(fb[pos : pos + pg.length], 0)
        codecs.add(c.name)
        pos += pg.length
    assert "FREQ" in codecs, f"shape didn't produce a FREQ page: {codecs}"
    arr = read_binary_column_fast(fb, meta, schema.field("s"))
    assert arr is not None, "FREQ string column fell off the fast path"
    assert arr.to_pylist() == list(v)
    assert read_table(p).column("s").to_pylist() == list(v)
