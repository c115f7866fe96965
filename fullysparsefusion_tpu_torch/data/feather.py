"""Feather V2 (the Arrow IPC file format) in NumPy, in place of pandas and
pyarrow, which the port does not depend on: the AV2 sensor logs' reader and
the AV2 result writer.

:func:`read_feather` reads the footer, the schema, the dictionaries and
every record batch (pyarrow writes batches of 64K rows), concatenated, into
``{column: array}`` in schema order. Columns of int8–64, uint8–64,
float16/32/64 and bool come out in their NumPy dtype, utf8 and large_utf8
and dictionary-encoded utf8 as ``object`` arrays of ``str``. Nulls become
NaN in float columns and raise in any other. The bodies may be uncompressed
or ``LZ4_FRAME``-compressed (pyarrow's default; the frames go through the
host library, ``native.lz4_frame_decompress``); ZSTD, nested types, other
types and big-endian files raise ``ValueError`` naming what was met. The
flatbuffers are parsed by hand.

:func:`write_feather` writes an uncompressed Feather V2 file that pyarrow
and pandas read: from rows (``pd.DataFrame(rows)``'s dtypes: Python float →
float64, int → int64, str → large_utf8, bool → bool) or from a dict of
NumPy columns of the dtypes above, in batches of 64K rows, with pandas'
schema metadata (a range index), so that ``pd.read_feather`` gives the frame
that ``pd.DataFrame(rows).to_feather`` would have written.
"""
from __future__ import annotations

import json
import os
import struct
from typing import Dict, List, Mapping, Sequence, Union

import numpy as np

from . import native

MAGIC = b"ARROW1"
BATCH_ROWS = 65536  # pyarrow's default chunk size for Feather V2

# flatbuffer unions and enums of Schema.fbs / Message.fbs / File.fbs
_INT, _FLOAT, _UTF8, _BOOL, _LARGE_UTF8 = 2, 3, 5, 6, 20
_TYPE_NAMES = {1: "null", 2: "int", 3: "floating point", 4: "binary", 5: "utf8", 6: "bool",
               7: "decimal", 8: "date", 9: "time", 10: "timestamp", 11: "interval", 12: "list",
               13: "struct", 14: "union", 15: "fixed-size binary", 16: "fixed-size list",
               17: "map", 18: "duration", 19: "large binary", 20: "large_utf8",
               21: "large list", 22: "run-end encoded", 23: "binary view", 24: "utf8 view"}
_SCHEMA, _DICTIONARY_BATCH, _RECORD_BATCH = 1, 2, 3
_LZ4_FRAME, _ZSTD = 0, 1
_V5 = 4
_FLOAT_DTYPES = ("<f2", "<f4", "<f8")


# -- flatbuffer reading -------------------------------------------------------------


class _Table:
    """A flatbuffer table at ``pos`` of ``buf``, read field by field."""

    __slots__ = ("buf", "pos", "vt", "vlen")

    def __init__(self, buf, pos: int):
        self.buf, self.pos = buf, pos
        self.vt = pos - struct.unpack_from("<i", buf, pos)[0]
        self.vlen = struct.unpack_from("<H", buf, self.vt)[0]

    def _field(self, slot: int) -> int:
        o = 4 + 2 * slot
        return struct.unpack_from("<H", self.buf, self.vt + o)[0] if o < self.vlen else 0

    def scalar(self, slot: int, fmt: str, default=0):
        f = self._field(slot)
        return struct.unpack_from("<" + fmt, self.buf, self.pos + f)[0] if f else default

    def _ref(self, slot: int):
        f = self._field(slot)
        if not f:
            return None
        q = self.pos + f
        return q + struct.unpack_from("<I", self.buf, q)[0]

    def table(self, slot: int):
        q = self._ref(slot)
        return None if q is None else _Table(self.buf, q)

    def vector(self, slot: int):
        q = self._ref(slot)
        return (0, 0) if q is None else (q + 4, struct.unpack_from("<I", self.buf, q)[0])

    def tables(self, slot: int) -> List["_Table"]:
        start, n = self.vector(slot)
        at = [start + 4 * i for i in range(n)]
        return [_Table(self.buf, a + struct.unpack_from("<I", self.buf, a)[0]) for a in at]

    def structs(self, slot: int, fmt: str) -> List[tuple]:
        size = struct.calcsize("<" + fmt)
        start, n = self.vector(slot)
        return [struct.unpack_from("<" + fmt, self.buf, start + i * size) for i in range(n)]

    def string(self, slot: int) -> str:
        start, n = self.vector(slot)
        return bytes(self.buf[start:start + n]).decode()


def _root(buf, pos: int = 0) -> _Table:
    return _Table(buf, pos + struct.unpack_from("<I", buf, pos)[0])


# -- reading -------------------------------------------------------------------------


def _value_kind(name: str, type_type: int, t, where: str):
    """A column's NumPy dtype, or ``"utf8"`` / ``"large_utf8"``."""
    if type_type == _INT:
        bits, signed = t.scalar(0, "i"), t.scalar(1, "?", False)
        if bits not in (8, 16, 32, 64):
            raise ValueError(f"{where}: column {name!r} has a {bits}-bit int")
        return np.dtype(f"<{'i' if signed else 'u'}{bits // 8}")
    if type_type == _FLOAT:
        return np.dtype(_FLOAT_DTYPES[t.scalar(0, "h")])
    if type_type == _BOOL:
        return np.dtype(bool)
    if type_type == _UTF8:
        return "utf8"
    if type_type == _LARGE_UTF8:
        return "large_utf8"
    raise ValueError(f"{where}: column {name!r} has Arrow type "
                     f"{_TYPE_NAMES.get(type_type, type_type)}, which is not read")


def _unpack_validity(buf, length: int) -> np.ndarray:
    return np.unpackbits(np.frombuffer(buf, np.uint8), bitorder="little")[:length].astype(bool)


def _decode_column(name: str, kind, length: int, nulls: int, bufs, where: str) -> np.ndarray:
    if isinstance(kind, str):
        offsets = np.frombuffer(bufs[1], "<i4" if kind == "utf8" else "<i8", count=length + 1)
        data = bytes(bufs[2])
        values = np.empty(length, object)
        values[:] = [data[offsets[i]:offsets[i + 1]].decode() for i in range(length)]
    elif kind == np.dtype(bool):
        values = _unpack_validity(bufs[1], length)
    else:
        values = np.frombuffer(bufs[1], kind, count=length).copy()
    if nulls:
        if kind not in [np.dtype(d) for d in _FLOAT_DTYPES]:
            raise ValueError(f"{where}: column {name!r} holds {nulls} nulls; only float "
                             "columns may (as NaN)")
        values[~_unpack_validity(bufs[0], length)] = np.nan
    return values


def _read_message(data: memoryview, offset: int, meta_len: int, body_len: int, where: str):
    """The IPC message of one footer block: (header type, header, body)."""
    if struct.unpack_from("<I", data, offset)[0] != 0xFFFFFFFF:
        raise ValueError(f"{where}: a message without the IPC continuation marker")
    msg = _root(data, offset + 8)
    return msg.scalar(1, "B"), msg.table(2), data[offset + meta_len:offset + meta_len + body_len]


def _body_buffers(rb: _Table, body: memoryview, where: str) -> list:
    """A record batch's buffers, each LZ4 frame decompressed."""
    comp = rb.table(3)
    codec = None if comp is None else comp.scalar(0, "b", _LZ4_FRAME)
    if codec == _ZSTD:
        raise ValueError(f"{where}: ZSTD body compression is not read "
                         "(write the file with compression='lz4' or 'uncompressed')")
    if codec not in (None, _LZ4_FRAME):
        raise ValueError(f"{where}: unknown body compression codec {codec}")
    out = []
    for off, length in rb.structs(2, "qq"):
        raw = body[off:off + length]
        if codec is not None and length:
            (size,) = struct.unpack_from("<q", raw, 0)
            raw = raw[8:] if size == -1 else native.lz4_frame_decompress(raw[8:], size).data
        out.append(raw)
    return out


def read_feather(path: Union[str, os.PathLike]) -> Dict[str, np.ndarray]:
    """A Feather V2 file → ``{column: array}`` in schema order, every record
    batch concatenated (see the module docstring for the types)."""
    where = os.fspath(path)
    with open(path, "rb") as f:
        data = memoryview(f.read())
    if bytes(data[:4]) == b"FEA1":
        raise ValueError(f"{where}: Feather V1 is not read")
    if len(data) < 18 or bytes(data[:6]) != MAGIC or bytes(data[-6:]) != MAGIC:
        raise ValueError(f"{where}: not a Feather V2 / Arrow IPC file (no ARROW1 magic)")
    (footer_len,) = struct.unpack_from("<i", data, len(data) - 10)
    footer = _root(data, len(data) - 10 - footer_len)
    schema = footer.table(1)
    if schema.scalar(0, "h") != 0:
        raise ValueError(f"{where}: big-endian Arrow data is not read")
    fields = []
    for fld in schema.tables(1):
        name = fld.string(0)
        if fld.vector(5)[1]:
            raise ValueError(f"{where}: column {name!r} is nested, which is not read")
        kind = _value_kind(name, fld.scalar(2, "B"), fld.table(3), where)
        enc = fld.table(4)
        index_kind = None
        if enc is not None:
            if not isinstance(kind, str):
                raise ValueError(f"{where}: column {name!r} is a dictionary of "
                                 f"{kind}; only utf8 dictionaries are read")
            it = enc.table(1)
            index_kind = np.dtype("<i4") if it is None else _value_kind(name, _INT, it, where)
            enc = enc.scalar(0, "q")
        fields.append((name, kind, enc, index_kind))
    names = [f[0] for f in fields]
    if len(set(names)) != len(names):
        raise ValueError(f"{where}: repeated column names {names}")

    kinds = {f[2]: f[1] for f in fields if f[2] is not None}
    dictionaries: Dict[int, np.ndarray] = {}
    for off, meta_len, body_len in footer.structs(2, "qi4xq"):
        kind_of, db, body = _read_message(data, off, meta_len, body_len, where)
        if kind_of != _DICTIONARY_BATCH:
            raise ValueError(f"{where}: a dictionary block holds message type {kind_of}")
        did, rb = db.scalar(0, "q"), db.table(1)
        (length, nulls), = rb.structs(1, "qq")
        values = _decode_column(f"dictionary {did}", kinds[did], length, nulls,
                                _body_buffers(rb, body, where), where)
        if db.scalar(2, "?", False) and did in dictionaries:
            values = np.concatenate([dictionaries[did], values])
        dictionaries[did] = values

    columns: Dict[str, List[np.ndarray]] = {n: [] for n in names}
    for off, meta_len, body_len in footer.structs(3, "qi4xq"):
        kind_of, rb, body = _read_message(data, off, meta_len, body_len, where)
        if kind_of != _RECORD_BATCH:
            raise ValueError(f"{where}: a record-batch block holds message type {kind_of}")
        nodes, bufs = rb.structs(1, "qq"), _body_buffers(rb, body, where)
        b = 0
        for (name, kind, dict_id, index_kind), (length, nulls) in zip(fields, nodes):
            if dict_id is not None:
                idx = _decode_column(name, index_kind, length, nulls, bufs[b:b + 2], where)
                columns[name].append(dictionaries[dict_id][idx])
                b += 2
            else:
                n_buf = 3 if isinstance(kind, str) else 2
                columns[name].append(
                    _decode_column(name, kind, length, nulls, bufs[b:b + n_buf], where))
                b += n_buf
    out = {}
    for name, kind, _, _ in fields:
        parts = columns[name]
        if parts:
            out[name] = np.concatenate(parts)
        else:
            out[name] = np.empty(0, object if isinstance(kind, str) else kind)
    return out


# -- flatbuffer writing ----------------------------------------------------------------


class _T:
    """A table to write: ``fields[slot]`` is None (absent), ``("s", fmt,
    value)`` a scalar, ``("t", _T)`` a table, ``("str", s)`` a string,
    ``("ts", [_T])`` a vector of tables, ``("vs", fmt, [tuple])`` a vector
    of structs (8-byte aligned)."""

    def __init__(self, *fields):
        self.fields = fields


class _FlatWriter:
    """Lays a table tree out front to back (each child after its parent, so
    every offset is forward), every table 8-byte aligned."""

    def __init__(self):
        self.buf = bytearray(4)

    def _pad(self, align: int, rem: int = 0):
        self.buf += b"\0" * ((rem - len(self.buf)) % align)

    def finish(self, root: _T) -> bytes:
        pos = self._table(root)
        struct.pack_into("<I", self.buf, 0, pos)
        self._pad(8)
        return bytes(self.buf)

    def _patch(self, at: int, target: int):
        struct.pack_into("<I", self.buf, at, target - at)

    def _table(self, t: _T) -> int:
        inline = []  # (slot, size, kind)
        for slot, f in enumerate(t.fields):
            if f is None:
                continue
            size = struct.calcsize("<" + f[1]) if f[0] == "s" else 4
            inline.append((slot, size, f))
        inline.sort(key=lambda x: -x[1])
        offsets, end = {}, 4
        for slot, size, _ in inline:
            end += (-end) % size
            offsets[slot] = end
            end += size
        end += (-end) % 4
        nslots = len(t.fields)
        self._pad(2)
        vt = len(self.buf)
        self.buf += struct.pack(f"<HH{nslots}H", 4 + 2 * nslots, end,
                                *[offsets.get(s, 0) for s in range(nslots)])
        self._pad(8)
        pos = len(self.buf)
        self.buf += bytes(end)
        struct.pack_into("<i", self.buf, pos, pos - vt)
        refs = []
        for slot, _, f in inline:
            if f[0] == "s":
                struct.pack_into("<" + f[1], self.buf, pos + offsets[slot], f[2])
            else:
                refs.append((pos + offsets[slot], f))
        for at, f in refs:
            self._patch(at, self._child(f))
        return pos

    def _child(self, f) -> int:
        kind = f[0]
        if kind == "t":
            return self._table(f[1])
        if kind == "str":
            self._pad(4)
            pos = len(self.buf)
            raw = f[1].encode()
            self.buf += struct.pack("<I", len(raw)) + raw + b"\0"
            return pos
        if kind == "ts":
            self._pad(4)
            pos = len(self.buf)
            self.buf += struct.pack("<I", len(f[1])) + bytes(4 * len(f[1]))
            for i, child in enumerate(f[1]):
                self._patch(pos + 4 + 4 * i, self._table(child))
            return pos
        if kind == "vs":
            self._pad(8, 4)
            pos = len(self.buf)
            self.buf += struct.pack("<I", len(f[2]))
            for item in f[2]:
                self.buf += struct.pack("<" + f[1], *item)
            return pos
        raise AssertionError(kind)


# -- writing -------------------------------------------------------------------------

# NumPy dtype → (Arrow type union tag, type table, pandas_type)
def _arrow_type(arr: np.ndarray):
    k = arr.dtype
    if k == object:
        return _LARGE_UTF8, _T(), "unicode"
    if k == np.dtype(bool):
        return _BOOL, _T(), "bool"
    if k.kind in "iu":
        return _INT, _T(("s", "i", k.itemsize * 8), ("s", "?", k.kind == "i")), k.name
    if k.kind == "f" and k.itemsize in (2, 4, 8):
        return _FLOAT, _T(("s", "h", {2: 0, 4: 1, 8: 2}[k.itemsize])), k.name
    raise TypeError(f"dtype {k} is not written")


def _column_from_values(name: str, values: Sequence) -> np.ndarray:
    """``pd.DataFrame(rows)``'s dtype for one column of Python values."""
    if all(isinstance(v, (bool, np.bool_)) for v in values):
        return np.asarray(values, bool)
    if all(isinstance(v, (int, np.integer)) and not isinstance(v, (bool, np.bool_))
           for v in values):
        return np.asarray(values, np.int64)
    if all(isinstance(v, (int, float, np.integer, np.floating))
           and not isinstance(v, (bool, np.bool_)) for v in values):
        return np.asarray(values, np.float64)
    if all(isinstance(v, str) for v in values):
        out = np.empty(len(values), object)
        out[:] = list(values)
        return out
    raise TypeError(f"column {name!r} mixes types {sorted({type(v).__name__ for v in values})}")


def _normalize(columns_or_rows) -> Dict[str, np.ndarray]:
    if isinstance(columns_or_rows, Mapping):
        cols = {}
        for k, v in columns_or_rows.items():
            a = np.asarray(v)
            if a.ndim != 1:
                raise ValueError(f"column {k!r} has shape {a.shape}; columns are 1-D")
            if a.dtype == object and not all(isinstance(x, str) for x in a):
                raise TypeError(f"column {k!r}: object columns must hold str")
            cols[str(k)] = a
        if len({len(a) for a in cols.values()}) > 1:
            raise ValueError(f"columns of unequal length {[len(a) for a in cols.values()]}")
        return cols
    rows = list(columns_or_rows)
    keys: List[str] = []
    for r in rows:
        keys += [k for k in r if k not in keys]
    for r in rows:
        if len(r) != len(keys):
            raise ValueError(f"rows with different keys: {sorted(r)} against {keys}")
    return {k: _column_from_values(k, [r[k] for r in rows]) for k in keys}


def _body(cols: Sequence[np.ndarray], lo: int, hi: int):
    """One record batch's body of rows [lo, hi): bytes, buffers, nodes."""
    body, bufs = bytearray(), []

    def add(raw: bytes):
        bufs.append((len(body), len(raw)))
        body.extend(raw)
        body.extend(bytes((-len(body)) % 8))

    for a in cols:
        part = a[lo:hi]
        add(b"")  # no validity bitmap: no nulls
        if a.dtype == object:
            raw = [s.encode() for s in part]
            add(np.concatenate([[0], np.cumsum([len(r) for r in raw], dtype=np.int64)])
                .astype("<i8").tobytes())
            add(b"".join(raw))
        elif a.dtype == np.dtype(bool):
            add(np.packbits(part, bitorder="little").tobytes())
        else:
            add(np.ascontiguousarray(part, a.dtype.newbyteorder("<")).tobytes())
    return bytes(body), bufs, [(hi - lo, 0)] * len(cols)


def _message(header_type: int, header: _T, body_len: int) -> bytes:
    fb = _FlatWriter().finish(_T(("s", "h", _V5), ("s", "B", header_type), ("t", header),
                              ("s", "q", body_len)))
    fb += bytes((-len(fb)) % 8)
    return struct.pack("<Ii", 0xFFFFFFFF, len(fb)) + fb


def _pandas_metadata(cols: Mapping[str, np.ndarray], n: int) -> str:
    """pandas' schema metadata for a frame with a default range index."""
    return json.dumps({
        "index_columns": [{"kind": "range", "name": None, "start": 0, "stop": n, "step": 1}],
        "column_indexes": [{"name": None, "field_name": None, "pandas_type": "unicode",
                            "numpy_type": "object", "metadata": {"encoding": "UTF-8"}}]
        if cols else [{"name": None, "field_name": None, "pandas_type": "int64",
                       "numpy_type": "int64", "metadata": None}],
        "columns": [{"name": k, "field_name": k, "pandas_type": _arrow_type(a)[2],
                     "numpy_type": "object" if a.dtype == object else a.dtype.name,
                     "metadata": None} for k, a in cols.items()],
        "attributes": {}, "creator": {"library": "fullysparsefusion_tpu_torch"}})


def write_feather(columns_or_rows, path: Union[str, os.PathLike]) -> None:
    """Write rows (a sequence of dicts with the same keys) or a dict of
    1-D NumPy columns as an uncompressed Feather V2 file, in record batches
    of ``BATCH_ROWS`` rows. No rows give a table with no columns, as
    ``pd.DataFrame([]).to_feather`` does."""
    cols = _normalize(columns_or_rows)
    n = len(next(iter(cols.values()))) if cols else 0
    fields = []
    for name, a in cols.items():
        tag, type_table, _ = _arrow_type(a)
        fields.append(_T(("str", name), ("s", "?", True), ("s", "B", tag), ("t", type_table),
                         None, ("ts", [])))
    meta = _T(("str", "pandas"), ("str", _pandas_metadata(cols, n)))
    schema = _T(None, ("ts", fields), ("ts", [meta]))
    out = bytearray(MAGIC + b"\0\0")
    out += _message(_SCHEMA, schema, 0)
    blocks = []
    arrays = list(cols.values())
    for lo in range(0, n, BATCH_ROWS):
        hi = min(lo + BATCH_ROWS, n)
        body, bufs, nodes = _body(arrays, lo, hi)
        rb = _T(("s", "q", hi - lo), ("vs", "qq", nodes), ("vs", "qq", bufs))
        meta_msg = _message(_RECORD_BATCH, rb, len(body))
        blocks.append((len(out), len(meta_msg), len(body)))
        out += meta_msg + body
    out += struct.pack("<Ii", 0xFFFFFFFF, 0)  # end of stream
    footer = _FlatWriter().finish(_T(("s", "h", _V5), ("t", schema), ("vs", "qi4xq", []),
                                  ("vs", "qi4xq", blocks)))
    out += footer + struct.pack("<i", len(footer)) + MAGIC
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with open(path, "wb") as f:
        f.write(out)
