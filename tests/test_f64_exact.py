"""f64 bit-exactness through the scan: the exact decoded bytes stay
host-side (``host_exact``) and drive materialization/re-encode, so a device
f64 copy that lost low mantissa bits (as on an accelerator that stores f64
as a float32 pair) never reaches the output."""

import os

import numpy as np
import pyarrow as pa

from strawboat.api import read_table, write_file
from strawboat.codecs import WriteOptions
from strawboat.constants import Compression
from strawboat.exec import scan_file


def _write(path, table, **kw):
    write_file(
        path,
        table,
        options=WriteOptions(
            default_compression=Compression.LZ4, max_page_size=1024, **kw
        ),
    )


def test_f64_streamed_path_keeps_exact_bytes(tmp_path):
    rng = np.random.default_rng(0)
    src = np.cumsum(rng.random(5000)) * 0.001
    path = str(tmp_path / "f.str")
    _write(path, pa.table({"a": pa.array(src)}))
    dt = scan_file(path)
    c = dt["a"]
    assert c.host_exact is not None
    assert np.array_equal(c.host_exact, src)
    # to_arrow must come from the exact bytes, not the device round-trip
    assert np.array_equal(np.asarray(dt.to_arrow().column("a")), src)


def test_f64_patas_path_keeps_exact_bytes(tmp_path):
    rng = np.random.default_rng(1)
    src = np.cumsum(rng.random(4096)) * 0.001
    path = str(tmp_path / "p.str")
    os.environ["STRAWBOAT_PATAS_COMPRESSION"] = "1"
    try:
        _write(path, pa.table({"a": pa.array(src)}))
    finally:
        del os.environ["STRAWBOAT_PATAS_COMPRESSION"]
    dt = scan_file(path)
    assert dt["a"].host_exact is not None
    assert np.array_equal(np.asarray(dt.to_arrow().column("a")), src)
    assert np.array_equal(np.asarray(read_table(path).column("a")), src)


def test_f64_exact_survives_lossy_device_values(tmp_path):
    """Even if the device copy degrades, to_arrow stays exact."""
    import jax.numpy as jnp

    rng = np.random.default_rng(2)
    src = np.cumsum(rng.random(2000)) * 0.001
    path = str(tmp_path / "g.str")
    _write(path, pa.table({"a": pa.array(src)}))
    dt = scan_file(path)
    c = dt["a"]
    # simulate a float32-pair degradation of the device copy
    degraded = jnp.asarray(
        (np.asarray(c.values).view(np.uint64) | 3).view(np.float64)
    )
    from strawboat.exec.scan import DeviceColumn, DeviceTable

    dt2 = DeviceTable(
        {"a": DeviceColumn("a", c.dtype, degraded, None, host_exact=c.host_exact)},
        dt.num_rows,
    )
    assert np.array_equal(np.asarray(dt2.to_arrow().column("a")), src)


def test_list_f64_leaf_keeps_exact_bytes(tmp_path):
    rng = np.random.default_rng(3)
    data = [
        [float(x) for x in rng.random(int(rng.integers(0, 4)))]
        for _ in range(500)
    ]
    path = str(tmp_path / "lf.str")
    _write(path, pa.table({"lf": pa.array(data, pa.list_(pa.float64()))}))
    dt = scan_file(path)
    assert dt["lf"].host_exact is not None
    assert dt.to_arrow().column("lf").to_pylist() == data


def test_f64_device_reencode_exact(tmp_path):
    """scan → write_device_table → read_table is bit-exact for f64."""
    from strawboat.write.device import write_device_table

    rng = np.random.default_rng(4)
    src = np.cumsum(rng.random(3000)) * 0.001
    p1, p2 = str(tmp_path / "a.str"), str(tmp_path / "b.str")
    _write(p1, pa.table({"a": pa.array(src)}))
    dt = scan_file(p1)
    write_device_table(
        p2, dt, WriteOptions(default_compression=Compression.LZ4, max_page_size=1024)
    )
    assert np.array_equal(np.asarray(read_table(p2).column("a")), src)
