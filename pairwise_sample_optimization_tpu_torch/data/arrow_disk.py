"""One string column of a HuggingFace ``datasets`` ``save_to_disk`` export,
read with the stdlib and numpy (no ``datasets``, no ``pyarrow``).

The layout ``Dataset.save_to_disk`` writes: a directory with ``state.json``
(``_data_files``: the shard files in order) and ``dataset_info.json``;
``DatasetDict.save_to_disk`` writes ``dataset_dict.json`` (``splits``) and
one such directory per split. Each shard is an Arrow IPC stream: messages
of a ``0xFFFFFFFF`` continuation marker, an int32 metadata length, a
flatbuffer ``Message`` (the Schema first, then RecordBatches) and the
message's body. The flatbuffer tables are parsed by hand, as far as
locating one column needs (``format/Message.fbs``, ``format/Schema.fbs``).

A ``utf8`` (int32 offsets) or ``large_utf8`` (int64 offsets) column is
read across every record batch of every shard; a null slot (its validity
bit clear) reads as ``None``. Refused, naming the file: a missing column,
a column of another type, a dictionary-encoded column, a compressed body
(LZ4 / ZSTD are not in the stdlib), a big-endian file, and any column
type whose buffers this reader cannot count ahead of the one asked for.
"""

from __future__ import annotations

import json
import os
import struct
from typing import Iterator, List, Optional, Tuple

import numpy as np

_SCHEMA, _DICTIONARY_BATCH, _RECORD_BATCH = 1, 2, 3  # MessageHeader union
_UTF8, _LARGE_UTF8 = 5, 20  # Type union
# buffers of one array of each Type (children add their own): Null, Int,
# FloatingPoint, Binary, Utf8, Bool, Decimal, Date, Time, Timestamp, Interval,
# List, Struct_, FixedSizeBinary, FixedSizeList, Map, Duration, LargeBinary,
# LargeUtf8, LargeList
_BUFFERS = {1: 0, 2: 2, 3: 2, 4: 3, 5: 3, 6: 2, 7: 2, 8: 2, 9: 2, 10: 2, 11: 2, 12: 2, 13: 1,
            15: 2, 16: 1, 17: 2, 18: 2, 19: 3, 20: 3, 21: 2}


class _Table:
    """A flatbuffer table at ``pos`` of ``buf``: fields by vtable slot."""

    def __init__(self, buf: memoryview, pos: int):
        self.buf, self.pos = buf, pos
        vtable = pos - struct.unpack_from("<i", buf, pos)[0]
        size = struct.unpack_from("<H", buf, vtable)[0]
        self.slots = struct.unpack_from(f"<{(size - 4) // 2}H", buf, vtable + 4)

    def _field(self, slot: int) -> int:
        """Absolute position of a field, 0 where it is absent."""
        return self.pos + self.slots[slot] if slot < len(self.slots) and self.slots[slot] else 0

    def scalar(self, slot: int, fmt: str, default=0):
        at = self._field(slot)
        return struct.unpack_from("<" + fmt, self.buf, at)[0] if at else default

    def _target(self, slot: int) -> int:
        at = self._field(slot)
        return at + struct.unpack_from("<I", self.buf, at)[0] if at else 0

    def table(self, slot: int) -> Optional["_Table"]:
        at = self._target(slot)
        return _Table(self.buf, at) if at else None

    def _vector(self, slot: int) -> Tuple[int, int]:
        at = self._target(slot)
        return (struct.unpack_from("<I", self.buf, at)[0], at + 4) if at else (0, 0)

    def tables(self, slot: int) -> List["_Table"]:
        n, start = self._vector(slot)
        at = [start + 4 * i for i in range(n)]
        return [_Table(self.buf, a + struct.unpack_from("<I", self.buf, a)[0]) for a in at]

    def string(self, slot: int) -> str:
        n, start = self._vector(slot)
        return bytes(self.buf[start:start + n]).decode("utf-8")

    def structs(self, slot: int) -> List[Tuple[int, int]]:
        """A vector of two-int64 structs (``FieldNode``, ``Buffer``)."""
        n, start = self._vector(slot)
        return [struct.unpack_from("<qq", self.buf, start + 16 * i) for i in range(n)]


def _messages(buf: memoryview) -> Iterator[Tuple[_Table, memoryview]]:
    """(Message table, body) of each message of an IPC stream, up to its end
    marker."""
    pos = 0
    while pos + 4 <= len(buf):
        (size,) = struct.unpack_from("<i", buf, pos)
        pos += 4
        if size == -1:  # the continuation marker, then the length
            (size,) = struct.unpack_from("<i", buf, pos)
            pos += 4
        if size == 0:
            return
        message = _Table(buf, pos + struct.unpack_from("<I", buf, pos)[0])
        body = pos + size
        body_len = message.scalar(3, "q")
        yield message, buf[body:body + body_len]
        pos = body + body_len


def _layout(field: _Table, path: str) -> Tuple[int, int]:
    """(field nodes, buffers) a field takes in a record batch."""
    if field.table(4) is not None:  # dictionary-encoded: its integer indices
        return 1, 2
    kind = field.scalar(2, "B")
    if kind not in _BUFFERS:
        raise NotImplementedError(f"{path}: column {field.string(0)!r} has Arrow type id {kind}, "
                                  "whose buffers this reader does not count")
    nodes, buffers = 1, _BUFFERS[kind]
    for child in field.tables(5):
        n, b = _layout(child, path)
        nodes, buffers = nodes + n, buffers + b
    return nodes, buffers


def read_shard_column(path: str, column: str) -> List[Optional[str]]:
    """The values of the string column ``column`` of one IPC stream file."""
    with open(path, "rb") as f:
        buf = memoryview(f.read())
    out: List[Optional[str]] = []
    node = first_buffer = offset_dtype = None
    for message, body in _messages(buf):
        kind, header = message.scalar(1, "B"), message.table(2)
        if kind == _SCHEMA:
            if header.scalar(0, "h"):
                raise NotImplementedError(f"{path}: a big-endian Arrow file")
            fields = header.tables(1)
            names = [fl.string(0) for fl in fields]
            if column not in names:
                raise KeyError(f"{path}: no column {column!r}; the columns are {names}")
            node = first_buffer = 0
            for fl in fields[:names.index(column)]:
                n, b = _layout(fl, path)
                node, first_buffer = node + n, first_buffer + b
            target = fields[names.index(column)]
            if target.table(4) is not None:
                raise NotImplementedError(f"{path}: column {column!r} is dictionary-encoded; "
                                          "the reader takes plain utf8 / large_utf8 columns")
            type_id = target.scalar(2, "B")
            if type_id not in (_UTF8, _LARGE_UTF8):
                raise NotImplementedError(f"{path}: column {column!r} has Arrow type id "
                                          f"{type_id}, not utf8 (5) or large_utf8 (20)")
            offset_dtype = "<i4" if type_id == _UTF8 else "<i8"
        elif kind == _RECORD_BATCH:
            if node is None:
                raise ValueError(f"{path}: a record batch before the schema")
            if header.table(3) is not None:
                codec = header.table(3).scalar(0, "b")
                raise NotImplementedError(f"{path}: compressed record batch body (BodyCompression "
                                          f"codec {['LZ4_FRAME', 'ZSTD'][codec]}); LZ4 and ZSTD "
                                          "are not in the stdlib")
            length, nulls = header.structs(1)[node]
            if not length:
                continue
            (v_at, v_len), (o_at, o_len), (d_at, d_len) = header.structs(2)[first_buffer:
                                                                            first_buffer + 3]
            offsets = np.frombuffer(body[o_at:o_at + o_len], dtype=offset_dtype, count=length + 1)
            data = bytes(body[d_at:d_at + d_len])
            valid = (np.unpackbits(np.frombuffer(body[v_at:v_at + v_len], np.uint8),
                                   bitorder="little")[:length].astype(bool)
                     if nulls and v_len else np.ones(length, bool))
            out += [data[offsets[i]:offsets[i + 1]].decode("utf-8") if valid[i] else None
                    for i in range(length)]
        elif kind != _DICTIONARY_BATCH:  # another column's dictionary is not needed
            raise NotImplementedError(f"{path}: Arrow message type {kind}")
    return out


def load_column(directory: str, column: str, split: Optional[str] = None) -> List[Optional[str]]:
    """``column`` of the ``save_to_disk`` export at ``directory``: of its
    ``split`` where it is a ``DatasetDict`` (a split it lacks is a
    ``KeyError`` listing its splits), of the ``Dataset`` itself otherwise
    (``split`` ignored), shard after shard."""
    dict_file = os.path.join(directory, "dataset_dict.json")
    if os.path.exists(dict_file):
        with open(dict_file) as f:
            splits = json.load(f)["splits"]
        if split is None or split not in splits:
            raise KeyError(f"{directory} holds splits {splits}; requested {split!r}")
        directory = os.path.join(directory, split)
    with open(os.path.join(directory, "state.json")) as f:
        shards = [d["filename"] for d in json.load(f)["_data_files"]]
    return [v for name in shards for v in read_shard_column(os.path.join(directory, name), column)]
