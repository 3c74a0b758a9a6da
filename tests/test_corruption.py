"""Corrupt-input handling: truncated/garbled files raise OutOfSpecError
(reference behavior: explicit size guards, e.g. integer/dict.rs:80-86)."""

import numpy as np
import pyarrow as pa
import pytest

from strawboat.api import read_table, write_file
from strawboat.codecs import WriteOptions
from strawboat.constants import Compression
from strawboat.errors import OutOfSpecError, StrawboatError


@pytest.fixture
def valid_file(tmp_path):
    path = str(tmp_path / "v.str")
    table = pa.table({"a": pa.array(np.arange(1000, dtype=np.int64))})
    write_file(
        path,
        table,
        options=WriteOptions(default_compression=Compression.LZ4, max_page_size=256),
    )
    return path


def _mutate(path, out, fn):
    raw = bytearray(open(path, "rb").read())
    fn(raw)
    with open(out, "wb") as f:
        f.write(raw)
    return out


def test_truncated_footer(valid_file, tmp_path):
    out = str(tmp_path / "t.str")
    raw = open(valid_file, "rb").read()
    with open(out, "wb") as f:
        f.write(raw[: len(raw) // 2])
    with pytest.raises(Exception):
        read_table(out)


def test_corrupt_codec_id(valid_file, tmp_path):
    out = _mutate(
        valid_file, str(tmp_path / "c.str"), lambda raw: raw.__setitem__(8, 99)
    )
    with pytest.raises(StrawboatError):
        read_table(out)


def test_corrupt_compressed_body(valid_file, tmp_path):
    def clobber(raw):
        for i in range(20, 60):
            raw[i] = 0xAB

    out = _mutate(valid_file, str(tmp_path / "b.str"), clobber)
    with pytest.raises(Exception):
        read_table(out)


def test_writer_state_machine(tmp_path):
    import io

    from strawboat.write.writer import NativeWriter

    table = pa.table({"a": pa.array([1], type=pa.int64())})
    w = NativeWriter(io.BytesIO(), table.schema, WriteOptions())
    with pytest.raises(OutOfSpecError):
        w.write(table)  # not started
    w.start()
    with pytest.raises(OutOfSpecError):
        w.start()  # double start
    w.write(table)
    with pytest.raises(OutOfSpecError):
        w.write(table)  # single row group only
    w.finish()
    with pytest.raises(OutOfSpecError):
        w.finish()


def test_zone_block_truncated_payload_ignored(tmp_path):
    """A corrupted in-band zone block must never crash or mis-prune: the
    reader validates structure and falls back to no-zones."""
    import numpy as np
    import pyarrow as pa

    from strawboat.api import write_file
    from strawboat.codecs import WriteOptions
    from strawboat.constants import Compression
    from strawboat.exec.pruning import read_zones

    table = pa.table({"k": pa.array(np.arange(4096, dtype=np.int64))})
    path = str(tmp_path / "z.str")
    write_file(
        path,
        table,
        options=WriteOptions(
            default_compression=Compression.LZ4, max_page_size=1024,
            zone_maps=True,
        ),
    )
    data = bytearray(open(path, "rb").read())
    assert read_zones(path) is not None
    # find the zone trailer (8 bytes before schema) and corrupt the payload
    import struct

    schema_size, meta_size = struct.unpack("<II", bytes(data[-16:-8]))
    schema_start = len(data) - 16 - meta_size - schema_size
    # clobber a byte inside the payload length field → structural parse fail
    data[schema_start - 8] ^= 0xFF
    bad = str(tmp_path / "bad.str")
    open(bad, "wb").write(bytes(data))
    assert read_zones(bad) is None  # never raises, never garbage zones


def test_file_without_zone_block_reads_none(tmp_path):
    import numpy as np
    import pyarrow as pa

    from strawboat.api import write_file
    from strawboat.codecs import WriteOptions
    from strawboat.constants import Compression
    from strawboat.exec.pruning import read_zones

    table = pa.table({"k": pa.array(np.arange(128, dtype=np.int64))})
    path = str(tmp_path / "nz.str")
    write_file(
        path, table,
        options=WriteOptions(default_compression=Compression.LZ4),
    )
    assert read_zones(path) is None
