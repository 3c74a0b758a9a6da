"""Golden byte-layout fixtures.

Locks the on-disk layout against regressions: exact bytes for tiny pages of
every codec family (layouts per SURVEY §1.1 / reference serialize code), plus
footer structure invariants.  If one of these changes, the format broke.
"""

import numpy as np
import pytest

from strawboat.codecs import WriteOptions
from strawboat.codecs.boolean import compress_boolean
from strawboat.codecs.integer import (
    bitpack_encode,
    compress_integer,
    delta_bitpack_encode,
)
from strawboat.constants import Compression
from strawboat.util import roaring
from strawboat.util.bits import pack_block128


def test_compress_header_layout():
    # [codec u8][compressed u32][uncompressed u32] + body (NONE = raw LE)
    buf = compress_integer(
        np.array([1, 2], dtype=np.int64), None, WriteOptions()
    )
    assert buf == bytes(
        [0, 16, 0, 0, 0, 16, 0, 0, 0]
    ) + (1).to_bytes(8, "little") + (2).to_bytes(8, "little")


def test_one_value_layout():
    buf = compress_integer(
        np.full(10, 7, dtype=np.int32),
        None,
        WriteOptions(default_compress_ratio=1.0),
    )
    # codec 12, body = single i32 LE
    assert buf[0] == 12
    assert buf[1:5] == (4).to_bytes(4, "little")
    assert buf[5:9] == (40).to_bytes(4, "little")
    assert buf[9:] == (7).to_bytes(4, "little")


def test_rle_layout():
    import os

    os.environ["STRAWBOAT_RLE_COMPRESSION"] = "1"
    try:
        buf = compress_integer(
            np.array([5, 5, 5, 9], dtype=np.int16), None, WriteOptions()
        )
    finally:
        del os.environ["STRAWBOAT_RLE_COMPRESSION"]
    # [u32 3][i16 5][u32 1][i16 9]
    assert buf[0] == 10
    body = buf[9:]
    assert body == (3).to_bytes(4, "little") + (5).to_bytes(2, "little") + (
        1
    ).to_bytes(4, "little") + (9).to_bytes(2, "little")


def test_bitpack_block_layout():
    # 128 values of 1 → num_bits 1 → header byte 1 + 16 bytes of 0xFF
    vals = np.ones(128, dtype=np.uint32)
    enc = bitpack_encode(vals)
    assert enc == bytes([1]) + b"\xff" * 16
    # num_bits from OR; BitPacker4x interleave: v[4t+l] = bit t of word-lane l
    vals2 = np.zeros(128, dtype=np.uint32)
    vals2[0] = 1  # lane 0, t 0 → lowest bit of first u32
    enc2 = bitpack_encode(vals2)
    assert enc2[0] == 1
    assert enc2[1:] == (1).to_bytes(4, "little") + bytes(12)


def test_delta_bitpack_num_bits_from_raw():
    vals = np.arange(128, dtype=np.uint32)  # max 127 → 7 bits (raw)
    enc = delta_bitpack_encode(vals)
    assert enc[0] == 7  # width from RAW values even though deltas are 1
    assert len(enc) == 1 + 7 * 16


def test_boolean_layout():
    buf = compress_boolean(
        np.array([1, 0, 1, 1, 0, 0, 0, 1, 1], dtype=bool), None, WriteOptions()
    )
    # uncompressed_size field = row count (boolean/mod.rs:58)
    assert buf[0] == 0
    assert int.from_bytes(buf[5:9], "little") == 9
    assert buf[9:] == bytes([0b10001101, 0b00000001])


def test_roaring_layout():
    ser = roaring.serialize(np.array([1, 5, 100000], dtype=np.uint32))
    # no-run cookie, 2 containers
    assert int.from_bytes(ser[0:4], "little") == 12346
    assert int.from_bytes(ser[4:8], "little") == 2
    # descriptive headers: key 0 card-1 1; key 1 card-1 0
    assert int.from_bytes(ser[8:10], "little") == 0
    assert int.from_bytes(ser[10:12], "little") == 1
    assert int.from_bytes(ser[12:14], "little") == 1
    assert int.from_bytes(ser[14:16], "little") == 0
    # offsets section present, then array containers
    assert int.from_bytes(ser[24:26], "little") == 1
    assert int.from_bytes(ser[26:28], "little") == 5
    assert int.from_bytes(ser[28:30], "little") == 100000 - 65536


def test_file_skeleton(tmp_path):
    import pyarrow as pa

    from strawboat.api import write_file

    path = str(tmp_path / "g.str")
    write_file(
        path,
        pa.table({"a": pa.array([1, 2, 3], type=pa.int64())}),
        options=WriteOptions(),
    )
    raw = open(path, "rb").read()
    assert raw[:8] == b"ARROW2\x00\x00"
    assert raw[-8:] == b"\xff\xff\xff\xff" + bytes(4)
    meta_size = int.from_bytes(raw[-12:-8], "little")
    schema_size = int.from_bytes(raw[-16:-12], "little")
    # meta block: u64 n_cols=1, offset=8, pages=1, [length, num_values=3]
    meta = raw[-16 - meta_size : -16]
    assert int.from_bytes(meta[0:8], "little") == 1
    assert int.from_bytes(meta[8:16], "little") == 8
    assert int.from_bytes(meta[16:24], "little") == 1
    assert int.from_bytes(meta[32:40], "little") == 3


# ---------------------------------------------------------------------------
# round-2 fixtures: hand-derived exact bytes for every remaining page layout
# (codec ids 0-16 × families + nullable/nested preludes).  Each layout cites
# the reference code that defines it; the bytes were derived from the format
# spec by hand, then locked.


def _env(name):
    import os

    class _Ctx:
        def __enter__(self):
            os.environ[name] = "1"

        def __exit__(self, *a):
            del os.environ[name]

    return _Ctx()


def test_integer_dict_layout():
    """Dict body = [recursive indices page][u32 unique][plain values]
    (reference src/compression/integer/dict.rs:34-72)."""
    from strawboat.codecs.integer import compress_integer, decompress_integer

    vals = np.array([7, 7, 9, 7], dtype=np.int64)
    with _env("STRAWBOAT_DICT_COMPRESSION"):
        buf = compress_integer(vals, None, WriteOptions())
    body = (
        # indices page: NONE codec, 4 × u32 LE codes [0,0,1,0]
        bytes([0]) + (16).to_bytes(4, "little") + (16).to_bytes(4, "little")
        + (0).to_bytes(4, "little") + (0).to_bytes(4, "little")
        + (1).to_bytes(4, "little") + (0).to_bytes(4, "little")
        # u32 unique count + plain i64 dict values
        + (2).to_bytes(4, "little")
        + (7).to_bytes(8, "little") + (9).to_bytes(8, "little")
    )
    expect = bytes([11]) + len(body).to_bytes(4, "little") + (32).to_bytes(
        4, "little"
    ) + body
    assert buf == expect
    out, _ = decompress_integer(np.frombuffer(buf, np.uint8), 0, 4, np.dtype(np.int64))
    np.testing.assert_array_equal(out, vals)


def test_integer_dict_null_handling_layout():
    """Nulls reuse the last index; a leading null pushes slot 0
    (reference integer/dict.rs:44-55)."""
    from strawboat.codecs.integer import compress_integer

    vals = np.array([7, 0, 9, 0], dtype=np.int64)
    validity = np.array([True, False, True, False])
    with _env("STRAWBOAT_DICT_COMPRESSION"):
        buf = compress_integer(vals, validity, WriteOptions())
    # codes: [0, 0 (repeat last), 1, 1 (repeat last)]; sets [7, 9]
    codes = buf[9 + 9 : 9 + 9 + 16]
    assert codes == (0).to_bytes(4, "little") * 2 + (1).to_bytes(4, "little") * 2


def test_integer_freq_layout():
    """Freq body = [top T][u32 bitmap_size][roaring exceptions bitmap]
    [recursive exceptions page] (reference integer/freq.rs:34-86)."""
    from strawboat.codecs.integer import compress_integer, decompress_integer

    vals = np.array([5] * 10 + [9], dtype=np.int64)
    with _env("STRAWBOAT_FREQ_COMPRESSION"):
        buf = compress_integer(vals, None, WriteOptions())
    # roaring bitmap of the single exception position 10:
    # [u32 cookie 12346][u32 1 container][u16 key 0][u16 card-1 0]
    # [u32 offset 16][u16 10]
    bitmap = (
        (12346).to_bytes(4, "little") + (1).to_bytes(4, "little")
        + (0).to_bytes(2, "little") + (0).to_bytes(2, "little")
        + (16).to_bytes(4, "little") + (10).to_bytes(2, "little")
    )
    assert len(bitmap) == 18
    body = (
        (5).to_bytes(8, "little")                      # top value
        + (18).to_bytes(4, "little") + bitmap          # exception bitmap
        # exceptions page: NONE codec, one i64
        + bytes([0]) + (8).to_bytes(4, "little") + (8).to_bytes(4, "little")
        + (9).to_bytes(8, "little")
    )
    expect = bytes([13]) + len(body).to_bytes(4, "little") + (88).to_bytes(
        4, "little"
    ) + body
    assert buf == expect
    out, _ = decompress_integer(np.frombuffer(buf, np.uint8), 0, 11, np.dtype(np.int64))
    np.testing.assert_array_equal(out, vals)


def test_patas_f64_layout():
    """Patas: first value raw LE, then per value [u16 pack(ref_diff,
    sig_bytes, trailing)] [sig_bytes of xor>>trailing] (reference
    double/patas.rs:36-105, pack at 144-150)."""
    from strawboat.codecs.double import patas_encode

    vals = np.array([1.0, 1.5, 1.0], dtype=np.float64)
    body = patas_encode(vals)
    # value 2 (1.5): xor=0x0008000000000000, trailing=51, sig_bits=1 →
    #   pack(1,1,51) = (1<<9)|(1<<6)|51 = 627; payload = 0x01
    # value 3 (1.0): xor with ref_diff=2 is 0 → is_equal → pack(2,0,63)
    expect = (
        np.float64(1.0).tobytes()
        + (627).to_bytes(2, "little") + bytes([1])
        + (1087).to_bytes(2, "little")
    )
    assert body == expect
    # framing under env forcing: codec 16 header
    from strawboat.codecs.double import compress_double, decompress_double

    with _env("STRAWBOAT_PATAS_COMPRESSION"):
        buf = compress_double(vals, None, WriteOptions())
    assert buf == bytes([16]) + (13).to_bytes(4, "little") + (24).to_bytes(
        4, "little"
    ) + expect
    out, _ = decompress_double(np.frombuffer(buf, np.uint8), 0, 3, np.dtype(np.float64))
    np.testing.assert_array_equal(out, vals)


def test_binary_raw_two_block_layout():
    """Binary raw page = TWO 9-byte-headed blocks: re-zeroed offsets then
    sliced values (reference binary/mod.rs:44-80)."""
    from strawboat.codecs.binary import compress_binary, decompress_binary

    offsets = np.array([0, 2, 3], dtype=np.int64)
    values = np.frombuffer(b"abc", np.uint8)
    buf = compress_binary(offsets, values, None, WriteOptions())
    expect = (
        bytes([0]) + (24).to_bytes(4, "little") + (24).to_bytes(4, "little")
        + offsets.tobytes()
        + bytes([0]) + (3).to_bytes(4, "little") + (3).to_bytes(4, "little")
        + b"abc"
    )
    assert buf == expect
    offs, vals, _ = decompress_binary(
        np.frombuffer(buf, np.uint8), 0, 2, np.dtype(np.int64)
    )
    np.testing.assert_array_equal(offs, offsets)
    assert vals.tobytes() == b"abc"


def test_binary_dict_layout():
    """Binary dict = [indices page][u32 count][[u64 len][bytes] sets]
    (reference binary/dict.rs:55-100)."""
    from strawboat.codecs.binary import compress_binary, decompress_binary

    offsets = np.array([0, 1, 2, 3, 4], dtype=np.int64)
    values = np.frombuffer(b"xyxx", np.uint8)
    with _env("STRAWBOAT_DICT_COMPRESSION"):
        buf = compress_binary(offsets, values, None, WriteOptions())
    body = (
        bytes([0]) + (16).to_bytes(4, "little") + (16).to_bytes(4, "little")
        + (0).to_bytes(4, "little") + (1).to_bytes(4, "little")
        + (0).to_bytes(4, "little") + (0).to_bytes(4, "little")
        + (2).to_bytes(4, "little")
        + (1).to_bytes(8, "little") + b"x"
        + (1).to_bytes(8, "little") + b"y"
    )
    expect = bytes([11]) + len(body).to_bytes(4, "little") + (4).to_bytes(
        4, "little"
    ) + body
    assert buf == expect
    offs, vals, _ = decompress_binary(
        np.frombuffer(buf, np.uint8), 0, 4, np.dtype(np.int64)
    )
    np.testing.assert_array_equal(offs, offsets)
    assert vals.tobytes() == b"xyxx"


def test_binary_freq_layout():
    """Binary freq = [u64 top_len][top][u32 bitmap_size][bitmap]
    [[u64 len][bytes] exceptions] (reference binary/freq.rs:44-101)."""
    from strawboat.codecs.binary import compress_binary, decompress_binary

    slices = [b"aa"] * 10 + [b"zz"]
    offsets = np.concatenate([[0], np.cumsum([len(s) for s in slices])]).astype(
        np.int64
    )
    values = np.frombuffer(b"".join(slices), np.uint8)
    with _env("STRAWBOAT_FREQ_COMPRESSION"):
        buf = compress_binary(offsets, values, None, WriteOptions())
    bitmap = (
        (12346).to_bytes(4, "little") + (1).to_bytes(4, "little")
        + (0).to_bytes(2, "little") + (0).to_bytes(2, "little")
        + (16).to_bytes(4, "little") + (10).to_bytes(2, "little")
    )
    body = (
        (2).to_bytes(8, "little") + b"aa"
        + (18).to_bytes(4, "little") + bitmap
        + (2).to_bytes(8, "little") + b"zz"
    )
    expect = bytes([13]) + len(body).to_bytes(4, "little") + (22).to_bytes(
        4, "little"
    ) + body
    assert buf == expect
    offs, vals, _ = decompress_binary(
        np.frombuffer(buf, np.uint8), 0, 11, np.dtype(np.int64)
    )
    np.testing.assert_array_equal(offs, offsets)
    assert vals.tobytes() == b"".join(slices)


def test_binary_one_value_layout():
    """Binary OneValue body = [u32 len][bytes] (binary/one_value.rs:50-64)."""
    from strawboat.codecs.binary import compress_binary

    offsets = np.array([0, 1, 2, 3], dtype=np.int64)
    values = np.frombuffer(b"qqq", np.uint8)
    buf = compress_binary(
        offsets, values, None, WriteOptions(default_compress_ratio=1.0)
    )
    body = (1).to_bytes(4, "little") + b"q"
    assert buf == bytes([12]) + (5).to_bytes(4, "little") + (3).to_bytes(
        4, "little"
    ) + body


def test_boolean_rle_layout():
    """Boolean RLE stores runs as [u32 len][u8 value] (boolean/rle.rs:31-55)."""
    import os

    os.environ["STRAWBOAT_RLE_COMPRESSION"] = "1"
    try:
        buf = compress_boolean(
            np.array([1, 1, 1, 0], dtype=bool), None, WriteOptions()
        )
    finally:
        del os.environ["STRAWBOAT_RLE_COMPRESSION"]
    body = (3).to_bytes(4, "little") + bytes([1]) + (1).to_bytes(
        4, "little"
    ) + bytes([0])
    assert buf == bytes([10]) + (10).to_bytes(4, "little") + (4).to_bytes(
        4, "little"
    ) + body


def test_boolean_one_value_layout():
    buf = compress_boolean(
        np.ones(5, dtype=bool), None, WriteOptions(default_compress_ratio=1.0)
    )
    assert buf == bytes([12]) + (1).to_bytes(4, "little") + (5).to_bytes(
        4, "little"
    ) + bytes([1])


def test_nullable_page_prelude_layout(tmp_path):
    """Nullable simple page = [u32 def_levels_len][bit-packed def levels]
    [non-nullable page] (reference serialize.rs:200-215; levels are parquet
    V2 hybrid-RLE, bit-packed run required by read_basic.rs:52-60)."""
    import pyarrow as pa

    from strawboat.api import write_file
    from strawboat.read.reader import read_meta

    path = str(tmp_path / "n.str")
    write_file(
        path,
        pa.table({"a": pa.array([1, None, 3], type=pa.int64())}),
        options=WriteOptions(),
    )
    raw = open(path, "rb").read()
    with open(path, "rb") as f:
        metas = read_meta(f)
    page = raw[metas[0].offset : metas[0].offset + metas[0].pages[0].length]
    # def levels: one bit-packed run of 1 group: header (1<<1)|1 = 3,
    # payload byte 0b101 (valid, null, valid LSB-first)
    prelude = (2).to_bytes(4, "little") + bytes([3, 0b00000101])
    leaf = (
        bytes([0]) + (24).to_bytes(4, "little") + (24).to_bytes(4, "little")
        + (1).to_bytes(8, "little") + (0).to_bytes(8, "little")
        + (3).to_bytes(8, "little")
    )
    assert page == prelude + leaf


def test_nested_page_prelude_layout(tmp_path):
    """Nested page = [u32 rows][u32 rep_len][u32 def_len][rep][def][leaf page]
    (reference serialize.rs:217-232).  Levels follow parquet Dremel for
    optional list of optional items: def 3 = present, 1 = empty list."""
    import pyarrow as pa

    from strawboat.api import write_file
    from strawboat.read.reader import read_meta

    path = str(tmp_path / "l.str")
    write_file(
        path,
        pa.table({"l": pa.array([[1, 2], [], [3]], type=pa.list_(pa.int64()))}),
        options=WriteOptions(),
    )
    raw = open(path, "rb").read()
    with open(path, "rb") as f:
        metas = read_meta(f)
    page = raw[metas[0].offset : metas[0].offset + metas[0].pages[0].length]
    assert metas[0].pages[0].num_values == 4  # level records, not rows
    # rep = [0,1,0,0] width 1 → bit-packed run [header 3, 0b0010]
    rep = bytes([3, 0b00000010])
    # def = [3,3,1,3] width 2 → [header 3, 0b11_01_11_11, 0x00]
    deff = bytes([3, 0b11011111, 0x00])
    prelude = (
        (3).to_bytes(4, "little")
        + (len(rep)).to_bytes(4, "little")
        + (len(deff)).to_bytes(4, "little")
        + rep
        + deff
    )
    leaf = (
        bytes([0]) + (24).to_bytes(4, "little") + (24).to_bytes(4, "little")
        + (1).to_bytes(8, "little") + (2).to_bytes(8, "little")
        + (3).to_bytes(8, "little")
    )
    assert page == prelude + leaf


def test_decimal128_none_layout(tmp_path):
    """Decimal128 rides the integer family as 16-byte LE two's-complement
    (reference integer/traits.rs:30-39 i128)."""
    import decimal

    import pyarrow as pa

    from strawboat.api import write_file
    from strawboat.read.reader import read_meta

    path = str(tmp_path / "d.str")
    write_file(
        path,
        pa.table(
            {
                "d": pa.array(
                    [decimal.Decimal("1.23"), decimal.Decimal("-4.56")],
                    type=pa.decimal128(10, 2),
                )
            }
        ),
        options=WriteOptions(),
    )
    raw = open(path, "rb").read()
    with open(path, "rb") as f:
        metas = read_meta(f)
    page = raw[metas[0].offset : metas[0].offset + metas[0].pages[0].length]
    body = (123).to_bytes(16, "little") + (-456).to_bytes(
        16, "little", signed=True
    )
    # nullable field with no nulls → def_levels_len 0 prelude (serialize.rs:207)
    assert page == (0).to_bytes(4, "little") + bytes([0]) + (32).to_bytes(
        4, "little"
    ) + (32).to_bytes(4, "little") + body


def test_patas_f32_layout_fixture_locked():
    """Patas f32: fixture-locked DIVERGENT stream (documented in
    codecs/double.py).  The reference's own f32 decode is unusable: ``unpack``
    (patas.rs:158-161) rewrites the f32 equal-marker (tz=31, sig=0) to
    sig=8, after which ``read_value_custom`` copies 8 bytes into the 4-byte
    ``T::Bytes`` buffer (UB) and ``consume``s 8 bytes the encoder never
    wrote — desyncing the stream.  We mark equality as tz == 31 for f32
    (== 63 for f64, where we are bit-identical, test_patas_f64_layout).
    (tz=31, sig=0) is unambiguous: a genuine xor with tz=31 has sig_bits=1.
    """
    from strawboat.codecs.double import patas_encode, patas_decode

    vals = np.array([1.0, 1.5, 1.0], dtype=np.float32)
    body = patas_encode(vals)
    # value 2 (1.5): xor=0x00400000, tz=22, lz=9, sig_bits=1, sig_bytes=1 →
    #   pack(1,1,22) = (1<<9)|(1<<6)|22 = 598; payload = 0x01
    # value 3 (1.0): xor with ref_diff=2 is 0 → is_equal → pack(2,0,31)
    expect = (
        np.float32(1.0).tobytes()
        + (598).to_bytes(2, "little") + bytes([1])
        + ((2 << 9) | 31).to_bytes(2, "little")
    )
    assert body == expect
    out, _ = patas_decode(np.frombuffer(body, np.uint8), 0, 3, np.dtype(np.float32))
    np.testing.assert_array_equal(out, vals)


def test_patas_f32_reads_reference_layout_stream():
    """Read-side compatibility: a hand-built f32 stream in the REFERENCE's
    byte layout with no equal markers (where the two layouts agree exactly)
    decodes to the right values."""
    from strawboat.codecs.double import patas_decode

    # values: 1.0, then 2.0 (xor=0x40000000^0x3f800000=0x7f800000, tz=23,
    # lz=1, sig_bits=8, sig_bytes=1, payload=0xff), then 8.0
    # (xor vs 2.0 = 0x41000000^0x40000000=0x01000000, tz=24, sig_bytes=1)
    stream = (
        np.float32(1.0).tobytes()
        + ((1 << 9) | (1 << 6) | 23).to_bytes(2, "little") + bytes([0xFF])
        + ((1 << 9) | (1 << 6) | 24).to_bytes(2, "little") + bytes([0x01])
    )
    out, _ = patas_decode(np.frombuffer(stream, np.uint8), 0, 3, np.dtype(np.float32))
    np.testing.assert_array_equal(out, np.array([1.0, 2.0, 8.0], np.float32))


def test_patas_f32_roundtrip_random():
    from strawboat.codecs.double import patas_encode, patas_decode

    rng = np.random.default_rng(9)
    # repeats + smooth values: exercises ring references AND equal markers,
    # through both the python and native paths (>256 values)
    base = rng.normal(0, 1, 400).astype(np.float32)
    vals = np.concatenate([base, base[:200], np.full(100, np.float32(3.25))])
    body = patas_encode(vals)
    out, _ = patas_decode(
        np.frombuffer(body, np.uint8), 0, len(vals), np.dtype(np.float32)
    )
    np.testing.assert_array_equal(out, vals)
