"""Parquet chunk files without pandas or pyarrow.

The JAX package writes its chunk files with ``pd.DataFrame(...).to_parquet(
compression="snappy")`` and reads them with ``pd.read_parquet``
(sskd_tpu/data/prepare.py, data/integrity.py, mining/bm25.py). The machine
with the GPU has neither library, so the port reads and writes the same
format here, in pure Python and numpy, for the subset those files use, and
the files stay interchangeable between the two packages:

- a flat schema (a root group of leaf columns), each column ``optional``
  or ``required``: BYTE_ARRAY annotated UTF8 (read as ``str``) or INT64
  (read as ``int``); a null is ``None``;
- definition levels in the RLE / bit-packed hybrid;
- PLAIN, PLAIN_DICTIONARY and RLE_DICTIONARY values, and dictionary pages;
- data pages v1 and v2, any number of row groups;
- the UNCOMPRESSED and SNAPPY codecs.

The footer is Thrift's compact protocol, read generically (every field
parsed, unknown ones ignored). Anything outside the subset (a nested or
repeated schema, another physical type, codec or encoding, an encrypted
footer, a column chunk in another file) raises :class:`DataError` naming
what it met; nothing is misread silently.

:func:`write_parquet` writes one row group, every column ``optional``, one
data page v1 a column with PLAIN values and RLE definition levels,
compressed with SNAPPY as a stream of literal runs (valid Snappy that any
reader decodes; the port never needs the space a real compressor saves).
"""

from __future__ import annotations

import struct
from pathlib import Path
from typing import Any, Sequence

import numpy as np

from sskd_tpu_torch.exceptions import DataError

MAGIC = b"PAR1"

# parquet.thrift enums
_TYPES = {0: "BOOLEAN", 1: "INT32", 2: "INT64", 3: "INT96", 4: "FLOAT", 5: "DOUBLE",
          6: "BYTE_ARRAY", 7: "FIXED_LEN_BYTE_ARRAY"}
_INT64, _BYTE_ARRAY = 2, 6
_CODECS = {0: "UNCOMPRESSED", 1: "SNAPPY", 2: "GZIP", 3: "LZO", 4: "BROTLI", 5: "LZ4",
           6: "ZSTD", 7: "LZ4_RAW"}
_ENCODINGS = {0: "PLAIN", 2: "PLAIN_DICTIONARY", 3: "RLE", 4: "BIT_PACKED",
              5: "DELTA_BINARY_PACKED", 6: "DELTA_LENGTH_BYTE_ARRAY", 7: "DELTA_BYTE_ARRAY",
              8: "RLE_DICTIONARY", 9: "BYTE_STREAM_SPLIT"}
_PLAIN, _PLAIN_DICTIONARY, _RLE, _RLE_DICTIONARY = 0, 2, 3, 8
_DATA_PAGE, _DICTIONARY_PAGE, _DATA_PAGE_V2 = 0, 2, 3
_PAGE_TYPES = {0: "DATA_PAGE", 1: "INDEX_PAGE", 2: "DICTIONARY_PAGE", 3: "DATA_PAGE_V2"}
_REQUIRED, _OPTIONAL = 0, 1
_UTF8 = 0  # ConvertedType


# ---------------------------------------------------------------------------
# Thrift compact protocol
# ---------------------------------------------------------------------------

# compact type ids
_T_STOP, _T_TRUE, _T_FALSE, _T_BYTE, _T_I16, _T_I32, _T_I64 = 0, 1, 2, 3, 4, 5, 6
_T_DOUBLE, _T_BINARY, _T_LIST, _T_SET, _T_MAP, _T_STRUCT = 7, 8, 9, 10, 11, 12


class _Reader:
    """Thrift compact values from ``buf`` at ``pos``; a struct reads as a
    dict {field id: value}, a list as a list, a binary as bytes."""

    def __init__(self, buf, pos: int = 0):
        self.buf, self.pos = buf, pos

    def byte(self) -> int:
        if self.pos >= len(self.buf):
            raise DataError("parquet: truncated thrift data")
        b = self.buf[self.pos]
        self.pos += 1
        return b

    def varint(self) -> int:
        out = shift = 0
        while True:
            b = self.byte()
            out |= (b & 0x7F) << shift
            if not b & 0x80:
                return out
            shift += 7

    def zigzag(self) -> int:
        n = self.varint()
        return (n >> 1) ^ -(n & 1)

    def value(self, t: int):
        if t in (_T_TRUE, _T_FALSE):  # a bool inside a list or map: one byte
            return self.byte() == 1
        if t == _T_BYTE:
            b = self.byte()
            return b - 256 if b > 127 else b
        if t in (_T_I16, _T_I32, _T_I64):
            return self.zigzag()
        if t == _T_DOUBLE:
            self.pos += 8
            return struct.unpack_from("<d", self.buf, self.pos - 8)[0]
        if t == _T_BINARY:
            n = self.varint()
            self.pos += n
            return bytes(self.buf[self.pos - n:self.pos])
        if t in (_T_LIST, _T_SET):
            head = self.byte()
            n, et = head >> 4, head & 0x0F
            if n == 15:
                n = self.varint()
            return [self.value(et) for _ in range(n)]
        if t == _T_MAP:
            n = self.varint()
            if n == 0:
                return {}
            kv = self.byte()
            return {self.value(kv >> 4): self.value(kv & 0x0F) for _ in range(n)}
        if t == _T_STRUCT:
            return self.struct()
        raise DataError(f"parquet: unknown thrift compact type {t}")

    def struct(self) -> dict:
        out, fid = {}, 0
        while True:
            head = self.byte()
            t = head & 0x0F
            if t == _T_STOP:
                return out
            delta = head >> 4
            fid = fid + delta if delta else self.zigzag()
            out[fid] = True if t == _T_TRUE else False if t == _T_FALSE else self.value(t)


def _varint(n: int) -> bytes:
    out = bytearray()
    while True:
        b = n & 0x7F
        n >>= 7
        if n:
            out.append(b | 0x80)
        else:
            out.append(b)
            return bytes(out)


def _zigzag(n: int) -> bytes:
    return _varint((n << 1) ^ (n >> 63))


def _struct(fields: Sequence[tuple[int, int, Any]]) -> bytes:
    """A compact-encoded struct of (field id, type, value) in increasing id
    order; a value of type _T_STRUCT is itself such a list, of _T_LIST a
    pair (element type, elements)."""
    out, last = bytearray(), 0
    for fid, t, v in fields:
        if t in (_T_TRUE, _T_FALSE):
            t = _T_TRUE if v else _T_FALSE
        delta = fid - last
        if 0 < delta <= 15:
            out.append((delta << 4) | t)
        else:
            out.append(t)
            out += _zigzag(fid)
        last = fid
        if t in (_T_TRUE, _T_FALSE):
            continue
        out += _value(t, v)
    out.append(_T_STOP)
    return bytes(out)


def _value(t: int, v) -> bytes:
    if t in (_T_I16, _T_I32, _T_I64):
        return _zigzag(int(v))
    if t == _T_BINARY:
        b = v.encode() if isinstance(v, str) else bytes(v)
        return _varint(len(b)) + b
    if t == _T_STRUCT:
        return _struct(v)
    if t == _T_LIST:
        et, items = v
        head = bytes([(len(items) << 4) | et]) if len(items) < 15 else (
            bytes([0xF0 | et]) + _varint(len(items)))
        return head + b"".join(_value(et, x) for x in items)
    raise DataError(f"parquet: the writer has no thrift type {t}")


# ---------------------------------------------------------------------------
# Snappy
# ---------------------------------------------------------------------------


def snappy_decompress(data) -> bytes:
    """Decode a raw Snappy stream: the varint uncompressed length, then
    literal runs and back-references (1-, 2- or 4-byte offsets; a copy may
    overlap what it writes)."""
    r = _Reader(data)
    n = r.varint()
    out = bytearray()
    buf, pos, end = data, r.pos, len(data)
    while pos < end:
        tag = buf[pos]
        pos += 1
        kind = tag & 3
        if kind == 0:
            length = tag >> 2
            if length >= 60:
                nb = length - 59
                length = int.from_bytes(buf[pos:pos + nb], "little")
                pos += nb
            length += 1
            if pos + length > end:
                raise DataError("parquet: snappy literal runs past the stream")
            out += buf[pos:pos + length]
            pos += length
            continue
        if kind == 1:
            length = 4 + ((tag >> 2) & 7)
            offset = ((tag >> 5) << 8) | buf[pos]
            pos += 1
        elif kind == 2:
            length = 1 + (tag >> 2)
            offset = int.from_bytes(buf[pos:pos + 2], "little")
            pos += 2
        else:
            length = 1 + (tag >> 2)
            offset = int.from_bytes(buf[pos:pos + 4], "little")
            pos += 4
        if offset == 0 or offset > len(out):
            raise DataError("parquet: snappy copy reaches before the stream")
        start = len(out) - offset
        if offset >= length:
            out += out[start:start + length]
        else:  # overlapping: the pattern repeats
            pattern = out[start:]
            reps, rest = divmod(length, offset)
            out += pattern * reps + pattern[:rest]
    if len(out) != n:
        raise DataError(f"parquet: snappy stream gave {len(out)} bytes, header says {n}")
    return bytes(out)


def snappy_compress(data: bytes) -> bytes:
    """A valid Snappy stream of ``data`` as literal runs of at most 64 KiB
    (no back-references)."""
    out = bytearray(_varint(len(data)))
    for a in range(0, len(data), 1 << 16):
        chunk = data[a:a + (1 << 16)]
        n = len(chunk) - 1
        if n < 60:
            out.append(n << 2)
        elif n < 256:
            out += bytes([60 << 2, n])
        else:
            out += bytes([61 << 2]) + n.to_bytes(2, "little")
        out += chunk
    return bytes(out)


# ---------------------------------------------------------------------------
# Levels and values
# ---------------------------------------------------------------------------


def _rle_hybrid(buf, pos: int, end: int, bit_width: int, count: int) -> np.ndarray:
    """``count`` values of the RLE / bit-packed hybrid in buf[pos:end]."""
    out = np.empty(count, np.int64)
    got = 0
    r = _Reader(buf, pos)
    nbytes = (bit_width + 7) // 8
    weights = (1 << np.arange(bit_width, dtype=np.int64)) if bit_width else None
    while got < count:
        if r.pos >= end:
            raise DataError("parquet: RLE / bit-packed levels end early")
        head = r.varint()
        if head & 1:  # bit-packed groups of 8
            n = (head >> 1) * 8
            size = (head >> 1) * bit_width
            raw = np.frombuffer(bytes(buf[r.pos:r.pos + size]), np.uint8)
            r.pos += size
            if bit_width:
                bits = np.unpackbits(raw, bitorder="little")[:n * bit_width]
                vals = bits.reshape(n, bit_width).astype(np.int64) @ weights
            else:
                vals = np.zeros(n, np.int64)
            take = min(n, count - got)
            out[got:got + take] = vals[:take]
            got += take
        else:  # a run of one value
            n = head >> 1
            v = int.from_bytes(bytes(buf[r.pos:r.pos + nbytes]), "little")
            r.pos += nbytes
            take = min(n, count - got)
            out[got:got + take] = v
            got += take
    return out


def _plain(buf, pos: int, ptype: int, count: int, utf8: bool) -> list:
    if ptype == _INT64:
        return np.frombuffer(bytes(buf[pos:pos + 8 * count]), "<i8").tolist()
    out = []
    for _ in range(count):
        n = int.from_bytes(buf[pos:pos + 4], "little")
        pos += 4
        raw = bytes(buf[pos:pos + n])
        pos += n
        out.append(raw.decode("utf-8") if utf8 else raw)
    return out


def _decompress(raw, codec: int, size: int):
    if codec == 0:
        return raw
    out = snappy_decompress(raw)
    if len(out) != size:
        raise DataError(f"parquet: a page decompressed to {len(out)} bytes, expected {size}")
    return out


# ---------------------------------------------------------------------------
# Reading
# ---------------------------------------------------------------------------


def _footer(data: bytes) -> dict:
    if len(data) < 12 or data[-4:] != MAGIC or data[:4] != MAGIC:
        if data[-4:] == b"PARE":
            raise DataError("parquet: encrypted footer (PARE) is not supported")
        raise DataError("parquet: not a parquet file (no PAR1 magic)")
    n = int.from_bytes(data[-8:-4], "little")
    meta = _Reader(data, len(data) - 8 - n).struct()
    if 8 in meta or 9 in meta:
        raise DataError("parquet: encrypted files are not supported")
    return meta


def _leaves(meta: dict) -> list[dict]:
    """The schema's leaf columns: {name, type, optional, utf8}; a nested or
    repeated schema raises."""
    schema = meta.get(2) or []
    if not schema:
        raise DataError("parquet: empty schema")
    root = schema[0]
    n = root.get(5, 0)
    if len(schema) != n + 1:
        raise DataError("parquet: nested schema (groups below the root) is not supported")
    out = []
    for el in schema[1:]:
        name = el.get(4, b"").decode()
        if el.get(5):
            raise DataError(f"parquet: column {name!r} is a group (nested schema)")
        rep = el.get(3, _REQUIRED)
        if rep not in (_REQUIRED, _OPTIONAL):
            raise DataError(f"parquet: column {name!r} is repeated")
        ptype = el.get(1)
        if ptype not in (_INT64, _BYTE_ARRAY):
            raise DataError(f"parquet: column {name!r} has physical type "
                            f"{_TYPES.get(ptype, ptype)}; only BYTE_ARRAY (UTF8) and INT64 "
                            "are read")
        logical = el.get(10) or {}
        utf8 = el.get(6) == _UTF8 or 1 in logical
        if ptype == _BYTE_ARRAY and not utf8:
            raise DataError(f"parquet: column {name!r} is a BYTE_ARRAY without the UTF8 "
                            "annotation")
        out.append({"name": name, "type": ptype, "optional": rep == _OPTIONAL, "utf8": utf8})
    return out


def _read_chunk(data: bytes, col: dict, md: dict, num_rows: int) -> list:
    """The values of one column chunk (ColumnMetaData ``md``)."""
    name = col["name"]
    codec = md.get(4, 0)
    if codec not in (0, 1):
        raise DataError(f"parquet: column {name!r} uses codec {_CODECS.get(codec, codec)}; "
                        "only UNCOMPRESSED and SNAPPY are read")
    total = md.get(5, 0)
    start = md.get(9)
    if md.get(11):
        start = min(start, md[11])
    pos = start
    dictionary = None
    values: list = []
    while len(values) < total:
        r = _Reader(data, pos)
        head = r.struct()
        body = r.pos
        ptype, usize, csize = head.get(1), head.get(2), head.get(3)
        pos = body + csize
        raw = memoryview(data)[body:body + csize]
        if ptype == _DICTIONARY_PAGE:
            dh = head.get(7) or {}
            if dh.get(2, _PLAIN) not in (_PLAIN, _PLAIN_DICTIONARY):
                raise DataError(f"parquet: column {name!r} has a dictionary page encoded "
                                f"{_ENCODINGS.get(dh.get(2), dh.get(2))}")
            page = _decompress(raw, codec, usize)
            dictionary = _plain(page, 0, col["type"], dh.get(1, 0), col["utf8"])
            continue
        if ptype == _DATA_PAGE:
            dh = head.get(5) or {}
            n, enc = dh.get(1, 0), dh.get(2, _PLAIN)
            page = _decompress(raw, codec, usize)
            p = 0
            if col["optional"]:
                if dh.get(3, _RLE) != _RLE:
                    raise DataError(f"parquet: column {name!r} has definition levels encoded "
                                    f"{_ENCODINGS.get(dh.get(3), dh.get(3))}")
                ln = int.from_bytes(page[:4], "little")
                defined = _rle_hybrid(page, 4, 4 + ln, 1, n)
                p = 4 + ln
            else:
                defined = None
        elif ptype == _DATA_PAGE_V2:
            dh = head.get(8) or {}
            n, enc = dh.get(1, 0), dh.get(4, _PLAIN)
            dlen, rlen = dh.get(5, 0), dh.get(6, 0)
            if rlen:
                raise DataError(f"parquet: column {name!r} has repetition levels")
            levels = bytes(raw[:dlen])
            rest = raw[dlen:]
            compressed = dh.get(7, True)
            page = _decompress(rest, codec if compressed else 0, usize - dlen)
            defined = _rle_hybrid(levels, 0, dlen, 1, n) if col["optional"] else None
            p = 0
        else:
            raise DataError(f"parquet: column {name!r} has a page of type "
                            f"{_PAGE_TYPES.get(ptype, ptype)}")
        n_present = n if defined is None else int(defined.sum())
        if enc == _PLAIN:
            present = _plain(page, p, col["type"], n_present, col["utf8"])
        elif enc in (_PLAIN_DICTIONARY, _RLE_DICTIONARY):
            if dictionary is None:
                raise DataError(f"parquet: column {name!r} has dictionary indices but no "
                                "dictionary page")
            width = page[p]
            idx = _rle_hybrid(page, p + 1, len(page), width, n_present)
            present = [dictionary[i] for i in idx.tolist()]
        else:
            raise DataError(f"parquet: column {name!r} has values encoded "
                            f"{_ENCODINGS.get(enc, enc)}; only PLAIN and dictionary "
                            "encodings are read")
        if defined is None:
            values.extend(present)
        else:
            it = iter(present)
            values.extend(next(it) if d else None for d in defined.tolist())
    if len(values) != num_rows:
        raise DataError(f"parquet: column {name!r} has {len(values)} values for {num_rows} rows")
    return values


def parquet_columns(path: str | Path) -> list[str]:
    """The column names of a parquet file, in schema order."""
    data = Path(path).read_bytes()
    return [c["name"] for c in _leaves(_footer(data))]


def read_parquet(path: str | Path, columns: Sequence[str] | None = None) -> dict[str, list]:
    """The columns of a parquet file as ``{name: [values]}`` (str, int or
    None), in the order of ``columns`` (default: every column, in schema
    order). A name the file lacks raises :class:`DataError`."""
    data = Path(path).read_bytes()
    meta = _footer(data)
    leaves = _leaves(meta)
    by_name = {c["name"]: (i, c) for i, c in enumerate(leaves)}
    names = [c["name"] for c in leaves] if columns is None else list(columns)
    missing = [n for n in names if n not in by_name]
    if missing:
        raise DataError(f"parquet: {path}: no column {missing}", details={"have": list(by_name)})
    out: dict[str, list] = {n: [] for n in names}
    for rg in meta.get(4) or []:
        chunks = rg.get(1) or []
        if len(chunks) != len(leaves):
            raise DataError("parquet: a row group's columns do not match the schema")
        for name in names:
            i, col = by_name[name]
            chunk = chunks[i]
            if chunk.get(1):
                raise DataError(f"parquet: column {name!r} lies in another file "
                                f"({chunk[1].decode()})")
            out[name].extend(_read_chunk(data, col, chunk.get(3) or {}, rg.get(3, 0)))
    return out


# ---------------------------------------------------------------------------
# Writing
# ---------------------------------------------------------------------------


def _column_type(name: str, values: list) -> int:
    kinds = {type(v) for v in values if v is not None}
    if not kinds or kinds == {str}:
        return _BYTE_ARRAY
    if all(issubclass(k, (int, np.integer)) and not issubclass(k, (bool, np.bool_))
           for k in kinds):
        return _INT64
    raise DataError(f"parquet: column {name!r} holds {sorted(k.__name__ for k in kinds)}; "
                    "the writer takes str or int (None for a null)")


def _def_levels(values: list) -> bytes:
    """Definition levels (1 defined, 0 null) as one bit-packed run of the
    hybrid encoding, with the v1 page's 4-byte length."""
    bits = np.fromiter((v is not None for v in values), np.uint8, len(values))
    groups = (len(values) + 7) // 8
    packed = np.packbits(np.pad(bits, (0, groups * 8 - len(values))), bitorder="little")
    body = _varint((groups << 1) | 1) + packed.tobytes()
    return len(body).to_bytes(4, "little") + body


def _plain_values(ptype: int, values: list) -> bytes:
    present = [v for v in values if v is not None]
    if ptype == _INT64:
        return np.asarray(present, dtype="<i8").tobytes()
    out = bytearray()
    for v in present:
        b = v.encode("utf-8")
        out += len(b).to_bytes(4, "little") + b
    return bytes(out)


def write_parquet(path: str | Path, columns: dict[str, list]) -> Path:
    """Write ``{name: [values]}`` (every list one length; str or int values,
    None for a null) as a parquet file that pandas and pyarrow read: one row
    group, optional columns (str as UTF8 BYTE_ARRAY, int as INT64), PLAIN
    values, SNAPPY."""
    names = list(columns)
    lengths = {len(columns[n]) for n in names}
    if len(lengths) > 1:
        raise DataError(f"parquet: columns of unequal lengths {sorted(lengths)}")
    num_rows = lengths.pop() if lengths else 0
    out = bytearray(MAGIC)
    chunks, schema = [], [[(4, _T_BINARY, "schema"), (5, _T_I32, len(names))]]
    for name in names:
        values = list(columns[name])
        ptype = _column_type(name, values)
        page = _def_levels(values) + _plain_values(ptype, values)
        body = snappy_compress(page)
        header = _struct([
            (1, _T_I32, _DATA_PAGE), (2, _T_I32, len(page)), (3, _T_I32, len(body)),
            (5, _T_STRUCT, [(1, _T_I32, num_rows), (2, _T_I32, _PLAIN), (3, _T_I32, _RLE),
                            (4, _T_I32, _RLE)]),
        ])
        offset = len(out)
        out += header + body
        md = [
            (1, _T_I32, ptype), (2, _T_LIST, (_T_I32, [_PLAIN, _RLE])),
            (3, _T_LIST, (_T_BINARY, [name])), (4, _T_I32, 1), (5, _T_I64, num_rows),
            (6, _T_I64, len(header) + len(page)), (7, _T_I64, len(header) + len(body)),
            (9, _T_I64, offset),
        ]
        chunks.append([(2, _T_I64, offset), (3, _T_STRUCT, md)])
        leaf = [(1, _T_I32, ptype), (3, _T_I32, _OPTIONAL), (4, _T_BINARY, name)]
        if ptype == _BYTE_ARRAY:  # UTF8, and the String logical type
            leaf += [(6, _T_I32, _UTF8), (10, _T_STRUCT, [(1, _T_STRUCT, [])])]
        schema.append(leaf)
    row_group = [(1, _T_LIST, (_T_STRUCT, chunks)), (2, _T_I64, len(out) - 4),
                 (3, _T_I64, num_rows)]
    footer = _struct([
        (1, _T_I32, 1), (2, _T_LIST, (_T_STRUCT, schema)), (3, _T_I64, num_rows),
        (4, _T_LIST, (_T_STRUCT, [row_group])), (6, _T_BINARY, "sskd_tpu_torch parquet writer"),
    ])
    out += footer + len(footer).to_bytes(4, "little") + MAGIC
    path = Path(path)
    path.write_bytes(bytes(out))
    return path
