"""TensorBoard event files of scalars, written and read without tensorflow
or tensorboard (neither is on the card machine).

An event file is a sequence of TFRecords (little-endian uint64 length, its
masked CRC32C, the bytes, their masked CRC32C), each one an `Event`
protocol buffer encoded here by hand: the first holds `file_version`
("brain.Event:2"), each later one `wall_time`, `step` and a `Summary` of
`Value{tag, simple_value}` entries.  TensorBoard reads these as scalars.

    w = EventWriter(log_dir)
    w.add_scalars(step, {"loss": 1.5, "lr": 2e-4})
    w.close()
    read_scalars(w.path)      # [(tag, step, value), ...]
"""

from __future__ import annotations

import os
import socket
import struct
import time
from typing import Dict, Iterator, List, Optional, Tuple


def _crc32c_table() -> List[int]:
    table = []
    for n in range(256):
        c = n
        for _ in range(8):
            c = (c >> 1) ^ 0x82F63B78 if c & 1 else c >> 1
        table.append(c)
    return table


_TABLE = _crc32c_table()


def crc32c(data: bytes) -> int:
    """CRC-32C (Castagnoli), as TFRecord frames use it."""
    c = 0xFFFFFFFF
    for b in data:
        c = _TABLE[(c ^ b) & 0xFF] ^ (c >> 8)
    return c ^ 0xFFFFFFFF


def masked_crc32c(data: bytes) -> int:
    c = crc32c(data)
    return (((c >> 15) | (c << 17)) + 0xA282EAD8) & 0xFFFFFFFF


def _varint(n: int) -> bytes:
    n &= (1 << 64) - 1                  # int64 two's complement
    out = bytearray()
    while True:
        b = n & 0x7F
        n >>= 7
        if n:
            out.append(b | 0x80)
        else:
            out.append(b)
            return bytes(out)


def _field(number: int, wire: int, payload: bytes) -> bytes:
    return _varint(number << 3 | wire) + payload


def _bytes_field(number: int, data: bytes) -> bytes:
    return _field(number, 2, _varint(len(data)) + data)


def encode_event(wall_time: float, step: int = 0,
                 scalars: Optional[Dict[str, float]] = None,
                 file_version: Optional[str] = None) -> bytes:
    """Event{wall_time = 1, step = 2, file_version = 3, summary = 5} with
    Summary{value = 1: Value{tag = 1, simple_value = 2 (float)}}."""
    out = _field(1, 1, struct.pack("<d", wall_time))
    if step:
        out += _field(2, 0, _varint(step))
    if file_version is not None:
        out += _bytes_field(3, file_version.encode())
    if scalars:
        summary = b"".join(
            _bytes_field(1, _bytes_field(1, tag.encode()) +
                         _field(2, 5, struct.pack("<f", float(value))))
            for tag, value in scalars.items())
        out += _bytes_field(5, summary)
    return out


def frame_record(data: bytes) -> bytes:
    """One TFRecord: length, its masked CRC, the data, its masked CRC."""
    length = struct.pack("<Q", len(data))
    return (length + struct.pack("<I", masked_crc32c(length)) + data +
            struct.pack("<I", masked_crc32c(data)))


class EventWriter:
    """Appends scalar events to `events.out.tfevents.<time>.<host>.<pid>`
    in `log_dir`, flushing after each call."""

    def __init__(self, log_dir: str):
        os.makedirs(log_dir, exist_ok=True)
        now = time.time()
        self.path = os.path.join(
            log_dir, f"events.out.tfevents.{int(now)}."
            f"{socket.gethostname()}.{os.getpid()}")
        self._f = open(self.path, "wb")
        self._write(encode_event(now, file_version="brain.Event:2"))

    def _write(self, event: bytes) -> None:
        self._f.write(frame_record(event))
        self._f.flush()

    def add_scalars(self, step: int, scalars: Dict[str, float]) -> None:
        self._write(encode_event(time.time(), step, scalars))

    def close(self) -> None:
        if not self._f.closed:
            self._f.close()


# ------------------------------------------------------------------ reading

def read_records(path: str) -> Iterator[bytes]:
    """The data of each TFRecord of `path`; raises ValueError on a bad CRC
    or a cut record."""
    with open(path, "rb") as f:
        while True:
            head = f.read(12)
            if not head:
                return
            if len(head) < 12:
                raise ValueError(f"{path}: cut record header")
            length, crc = struct.unpack("<QI", head)
            if masked_crc32c(head[:8]) != crc:
                raise ValueError(f"{path}: bad length CRC")
            data = f.read(length)
            tail = f.read(4)
            if len(data) < length or len(tail) < 4:
                raise ValueError(f"{path}: cut record")
            if masked_crc32c(data) != struct.unpack("<I", tail)[0]:
                raise ValueError(f"{path}: bad data CRC")
            yield data


def _fields(data: bytes) -> Iterator[Tuple[int, int, object]]:
    """(field number, wire type, value) of a protocol buffer message:
    an int for varints, bytes for the rest."""
    i = 0
    while i < len(data):
        key, i = _read_varint(data, i)
        number, wire = key >> 3, key & 7
        if wire == 0:
            value, i = _read_varint(data, i)
        elif wire == 1:
            value, i = data[i:i + 8], i + 8
        elif wire == 2:
            n, i = _read_varint(data, i)
            value, i = data[i:i + n], i + n
        elif wire == 5:
            value, i = data[i:i + 4], i + 4
        else:
            raise ValueError(f"wire type {wire} not supported")
        yield number, wire, value


def _read_varint(data: bytes, i: int) -> Tuple[int, int]:
    shift = n = 0
    while True:
        b = data[i]
        i += 1
        n |= (b & 0x7F) << shift
        shift += 7
        if not b & 0x80:
            return n, i


def read_scalars(path: str) -> List[Tuple[str, int, float]]:
    """(tag, step, simple_value) of every scalar in the event file."""
    out = []
    for data in read_records(path):
        step, values = 0, []
        for number, _, value in _fields(data):
            if number == 2:
                step = value - (1 << 64) if value >> 63 else value
            elif number == 5:
                for vn, _, v in _fields(value):
                    if vn != 1:
                        continue
                    tag, simple = None, None
                    for fn, _, x in _fields(v):
                        if fn == 1:
                            tag = x.decode()
                        elif fn == 2:
                            simple = struct.unpack("<f", x)[0]
                    if tag is not None and simple is not None:
                        values.append((tag, simple))
        out += [(tag, step, v) for tag, v in values]
    return out
