"""The port's Feather V2 reader and writer (``data/feather.py``, the LZ4
frames in ``csrc/lz4.cpp``) against pandas and pyarrow, all bitwise: files
that pyarrow writes (uncompressed, LZ4, 64K + 1 rows in two batches,
float16, strings, dictionaries, float nulls) read equal to
``pd.read_feather``; ZSTD and the kinds that are not read raise; files that
the port writes read back in pandas equal (``assert_frame_equal``) to
``pd.DataFrame(rows).to_feather`` of the same rows, zero rows included; the
LZ4 frames of pyarrow's codec, and hand-made frames with every optional
field and dependent and independent blocks, decompress exactly."""
import json
import os
import struct

import numpy as np
import pandas as pd
import pyarrow as pa
import pyarrow.feather as pf
import pytest

from fullysparsefusion_tpu_torch.data import native
from fullysparsefusion_tpu_torch.data.feather import read_feather, write_feather
from test_torch_ddp_port import torch_one_thread  # noqa: F401 (autouse)
from torch_offline_fixtures.make_fixtures import (FEATHERS, HERE, column_digest, feather_table,
                                                  pandas_columns)

pytestmark = pytest.mark.filterwarnings("ignore::FutureWarning")


def assert_columns_equal(got, want):
    assert list(got) == list(want)
    for k in want:
        assert got[k].dtype == want[k].dtype, k
        if got[k].dtype.kind == "f":
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)  # NaN == NaN here
        else:
            assert got[k].tolist() == want[k].tolist(), k


@pytest.mark.parametrize("compression,rows", [("uncompressed", 1000), ("lz4", 1000),
                                              ("lz4", 65537), ("uncompressed", 65537)])
def test_pyarrow_files_read_as_pandas(tmp_path, compression, rows):
    path = str(tmp_path / "t.feather")
    pf.write_feather(feather_table(rows, rows), path, compression=compression)
    got = read_feather(path)
    assert_columns_equal(got, pandas_columns(path))
    assert len(got["x"]) == rows and got["x"].dtype == np.float16
    assert np.isnan(got["maybe"]).any() and got["log_id"].dtype == object


def test_committed_fixtures_match_manifest():
    with open(os.path.join(HERE, "manifest.json")) as f:
        manifest = json.load(f)["feather"]
    assert set(manifest) == set(FEATHERS)
    for name, entry in manifest.items():
        path = os.path.join(HERE, name)
        if "port_raises" in entry:
            with pytest.raises(ValueError, match=entry["port_raises"]):
                read_feather(path)
            continue
        got = read_feather(path)
        assert {k: (str(v.dtype), column_digest(v)) for k, v in got.items()} == \
            {k: (c["dtype"], c["sha256"]) for k, c in entry["columns"].items()}, name
        assert len(got["x"]) == entry["rows"]


def test_unsupported_files_raise(tmp_path):
    zstd = str(tmp_path / "z.feather")
    pf.write_feather(feather_table(10, 0), zstd, compression="zstd")
    with pytest.raises(ValueError, match="ZSTD"):
        read_feather(zstd)
    nulls = str(tmp_path / "n.feather")
    pf.write_feather(pa.table({"i": pa.array([1, None, 3], pa.int32())}), nulls)
    with pytest.raises(ValueError, match="only float columns"):
        read_feather(nulls)
    nested = str(tmp_path / "l.feather")
    pf.write_feather(pa.table({"l": pa.array([[1], [2, 3]])}), nested)
    with pytest.raises(ValueError, match="nested"):
        read_feather(nested)
    ts = str(tmp_path / "ts.feather")
    pf.write_feather(pa.table({"t": pa.array([1, 2], pa.timestamp("ns"))}), ts)
    with pytest.raises(ValueError, match="timestamp"):
        read_feather(ts)


def _rows(n, seed=0):
    rng = np.random.default_rng(seed)
    return [dict(tx_m=float(rng.normal()), ty_m=float(rng.normal()), score=float(rng.random()),
                 category=("REGULAR_VEHICLE", "BUS", "PEDESTRIAN")[i % 3], log_id="log_a",
                 timestamp_ns=int(3 * 10**17 + i), count=int(rng.integers(-5, 5)))
            for i in range(n)]


@pytest.mark.parametrize("n", [0, 1, 7, 70000])
def test_port_written_rows_read_as_pandas_written(tmp_path, n):
    rows = _rows(n)
    mine, theirs = str(tmp_path / "mine.feather"), str(tmp_path / "theirs.feather")
    write_feather(rows, mine)
    pd.DataFrame(rows).to_feather(theirs)
    pd.testing.assert_frame_equal(pd.read_feather(mine), pd.read_feather(theirs))
    assert_columns_equal(read_feather(mine), read_feather(theirs))


def test_port_written_numpy_columns_round_trip(tmp_path):
    rng = np.random.default_rng(1)
    n = 70001  # two batches
    cols = {"x": rng.normal(size=n).astype(np.float16),
            "i": rng.integers(0, 255, n).astype(np.uint8),
            "o": rng.integers(-9, 9, n).astype(np.int32), "t": rng.integers(0, 2**62, n),
            "f": rng.random(n).astype(np.float32), "b": rng.random(n) > 0.5,
            "s": np.array([f"s{k % 11}" for k in range(n)], object)}
    path = str(tmp_path / "c.feather")
    write_feather(cols, path)
    assert_columns_equal(read_feather(path), cols)
    assert_columns_equal(pandas_columns(path), cols)
    with pytest.raises(ValueError, match="unequal length"):
        write_feather({"a": np.zeros(2), "b": np.zeros(3)}, path)
    with pytest.raises(ValueError, match="different keys"):
        write_feather([{"a": 1.0}, {"b": 2.0}], path)


def _frame(flg: int, blocks, content: bytes) -> bytes:
    """An LZ4 frame: header (content size when flagged), blocks (raw, and
    whether stored), a junk block checksum and content checksum when
    flagged (the decoder skips them)."""
    out = struct.pack("<IBB", 0x184D2204, flg, 0x40)
    if flg & 0x08:
        out += struct.pack("<Q", len(content))
    out += b"\x00"  # header checksum, not verified
    for data, stored in blocks:
        out += struct.pack("<I", len(data) | (0x80000000 if stored else 0)) + data
        out += b"\xde\xad\xbe\xef" if flg & 0x10 else b""
    return out + b"\x00" * 4 + (b"\xca\xfe\xba\xbe" if flg & 0x04 else b"")


def test_lz4_frames_decompress_exactly():
    rng = np.random.default_rng(3)
    codec = pa.Codec("lz4")
    for raw in (b"", np.arange(70000, dtype=np.int32).tobytes(), rng.bytes(150000),
                np.repeat(rng.integers(0, 4, 30000, dtype=np.uint8), 9).tobytes()):
        frame = codec.compress(raw).to_pybytes()
        assert native.lz4_frame_decompress(frame, len(raw)).tobytes() == raw
    # block 1: "abcd" + a match 4 back of 8 + "efghi"; block 2 stored
    first = b"\x44abcd\x04\x00\x50efghi"
    content = b"abcdabcdabcdefghi" + b"stored!"
    for flg in (0x7C, 0x60, 0x40):  # every optional field / independent / neither
        frame = _frame(flg, [(first, False), (b"stored!", True)], content)
        assert native.lz4_frame_decompress(frame, len(content)).tobytes() == content
    # block 2 reaches 17 bytes back into block 1: allowed only for dependent blocks
    second = b"\x04\x11\x00\x10z"
    want = b"abcdabcdabcdefghi" + b"abcdabcdz"
    dependent = _frame(0x40, [(first, False), (second, False)], want)
    assert native.lz4_frame_decompress(dependent, len(want)).tobytes() == want
    with pytest.raises(ValueError, match="corrupt block"):
        native.lz4_frame_decompress(_frame(0x60, [(first, False), (second, False)], want),
                                    len(want))
    with pytest.raises(ValueError, match="expected 30"):
        native.lz4_frame_decompress(dependent, 30)
    with pytest.raises(ValueError, match="truncated"):
        native.lz4_frame_decompress(dependent[:-6], len(want))
    with pytest.raises(ValueError, match="magic"):
        native.lz4_frame_decompress(b"\x00" * 12, 1)
