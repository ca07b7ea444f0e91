"""Dependency-free TensorBoard scalar event writer (a copy of
``tpuic/metrics/tensorboard.py``).

The port writes JSONL (``metrics/logging.py``) and, with this module,
standard ``events.out.tfevents.*`` files that TensorBoard's scalar
dashboard reads directly.

No TensorFlow / tensorboardX dependency: the format is hand-encoded.

- **TFRecord framing** (record_writer.cc): ``uint64 length | uint32
  masked_crc32c(length_bytes) | payload | uint32 masked_crc32c(payload)``
  with the masked Castagnoli CRC ``((crc >> 15 | crc << 17) + 0xa282ead8)``.
- **Event proto** (event.proto), fields hand-encoded in wire format:
  ``wall_time``(1, double) ``step``(2, int64) ``file_version``(3, string)
  ``summary``(5, message) — Summary.value(1) {tag(1, string),
  simple_value(2, float)}.

``tests/test_torch_port_telemetry.py`` round-trips files through the
independent reader (also in this module) that verifies both CRCs and re-decodes the protos.
"""

from __future__ import annotations

import os
import socket
import struct
import threading
import time
from typing import Iterator, List, Optional, Tuple

# -- crc32c (Castagnoli, table-driven) ---------------------------------------

_CRC_TABLE: List[int] = []


def _crc_table() -> List[int]:
    global _CRC_TABLE
    if not _CRC_TABLE:
        poly = 0x82F63B78  # reversed Castagnoli
        table = []
        for i in range(256):
            c = i
            for _ in range(8):
                c = (c >> 1) ^ poly if c & 1 else c >> 1
            table.append(c)
        _CRC_TABLE = table
    return _CRC_TABLE


def crc32c(data: bytes) -> int:
    table = _crc_table()
    crc = 0xFFFFFFFF
    for b in data:
        crc = table[(crc ^ b) & 0xFF] ^ (crc >> 8)
    return crc ^ 0xFFFFFFFF


def _masked_crc(data: bytes) -> int:
    crc = crc32c(data)
    return (((crc >> 15) | (crc << 17)) + 0xA282EAD8) & 0xFFFFFFFF


# -- minimal protobuf wire encoding ------------------------------------------

def _varint(n: int) -> bytes:
    out = bytearray()
    while True:
        b = n & 0x7F
        n >>= 7
        out.append(b | (0x80 if n else 0))
        if not n:
            return bytes(out)


def _key(field: int, wire: int) -> bytes:
    return _varint((field << 3) | wire)


def _len_delim(field: int, payload: bytes) -> bytes:
    return _key(field, 2) + _varint(len(payload)) + payload


def _double(field: int, v: float) -> bytes:
    return _key(field, 1) + struct.pack("<d", v)


def _float32(field: int, v: float) -> bytes:
    return _key(field, 5) + struct.pack("<f", v)


def _event(step: int, scalars: Tuple[Tuple[str, float], ...] = (),
           file_version: Optional[str] = None,
           wall_time: Optional[float] = None) -> bytes:
    msg = _double(1, time.time() if wall_time is None else wall_time)
    msg += _key(2, 0) + _varint(step & 0xFFFFFFFFFFFFFFFF)
    if file_version is not None:
        msg += _len_delim(3, file_version.encode())
    if scalars:
        summary = b"".join(
            _len_delim(1, _len_delim(1, tag.encode()) + _float32(2, val))
            for tag, val in scalars)
        msg += _len_delim(5, summary)
    return msg


class TensorBoardWriter:
    """``events.out.tfevents.<ts>.<host>`` scalar writer."""

    def __init__(self, log_dir: str) -> None:
        os.makedirs(log_dir, exist_ok=True)
        name = f"events.out.tfevents.{int(time.time())}.{socket.gethostname()}"
        self._fh = open(os.path.join(log_dir, name), "ab")
        # Records interleave from more than one thread since the telemetry
        # bridge landed: the loop thread writes scalars while the
        # TensorBoardSink relays quarantine events from dataset producer
        # threads. A record is four sequential writes (header, CRC,
        # payload, CRC) — unserialized interleaving corrupts the CRC
        # framing and truncates the file for every reader.
        self._lock = threading.Lock()
        self._record(_event(0, file_version="brain.Event:2"))

    def _record(self, payload: bytes) -> None:
        header = struct.pack("<Q", len(payload))
        with self._lock:
            if self._fh is None:
                return
            self._fh.write(header)
            self._fh.write(struct.pack("<I", _masked_crc(header)))
            self._fh.write(payload)
            self._fh.write(struct.pack("<I", _masked_crc(payload)))
            self._fh.flush()

    def scalars(self, step: int, **values: float) -> None:
        if values:
            self._record(_event(step, tuple(
                (k, float(v)) for k, v in sorted(values.items()))))

    def close(self) -> None:
        with self._lock:
            if self._fh is not None:
                self._fh.close()
                self._fh = None


# -- independent reader (tests + debugging) ----------------------------------

def read_events(path: str) -> Iterator[dict]:
    """Decode an events file, VERIFYING both CRCs per record. Yields
    {'step': int, 'wall_time': float, 'scalars': {tag: value}} (the
    file_version record yields scalars={})."""
    with open(path, "rb") as f:
        data = f.read()
    pos = 0
    while pos < len(data):
        if pos + 12 > len(data):
            raise ValueError(f"truncated record header at {pos}")
        (length,) = struct.unpack_from("<Q", data, pos)
        header = data[pos:pos + 8]
        (hcrc,) = struct.unpack_from("<I", data, pos + 8)
        if _masked_crc(header) != hcrc:
            raise ValueError(f"bad header crc at {pos}")
        if pos + 12 + length + 4 > len(data):
            raise ValueError(f"truncated record payload at {pos}")
        payload = data[pos + 12:pos + 12 + length]
        (pcrc,) = struct.unpack_from("<I", data, pos + 12 + length)
        if _masked_crc(payload) != pcrc:
            raise ValueError(f"bad payload crc at {pos}")
        pos += 12 + length + 4
        yield _decode_event(payload)


def _read_varint(buf: bytes, pos: int) -> Tuple[int, int]:
    shift = n = 0
    while True:
        b = buf[pos]
        pos += 1
        n |= (b & 0x7F) << shift
        if not b & 0x80:
            return n, pos
        shift += 7


def _decode_event(buf: bytes) -> dict:
    out = {"step": 0, "wall_time": 0.0, "scalars": {}}
    pos = 0
    while pos < len(buf):
        key, pos = _read_varint(buf, pos)
        field, wire = key >> 3, key & 7
        if field == 1 and wire == 1:
            (out["wall_time"],) = struct.unpack_from("<d", buf, pos)
            pos += 8
        elif field == 2 and wire == 0:
            out["step"], pos = _read_varint(buf, pos)
        elif field == 5 and wire == 2:
            ln, pos = _read_varint(buf, pos)
            out["scalars"].update(_decode_summary(buf[pos:pos + ln]))
            pos += ln
        elif wire == 2:  # skip unknown length-delimited (file_version etc.)
            ln, pos = _read_varint(buf, pos)
            pos += ln
        elif wire == 0:
            _, pos = _read_varint(buf, pos)
        elif wire == 1:
            pos += 8
        elif wire == 5:
            pos += 4
        else:
            raise ValueError(f"unknown wire type {wire}")
    return out


def _decode_summary(buf: bytes) -> dict:
    scalars = {}
    pos = 0
    while pos < len(buf):
        key, pos = _read_varint(buf, pos)
        if key >> 3 == 1 and key & 7 == 2:
            ln, pos = _read_varint(buf, pos)
            val = buf[pos:pos + ln]
            pos += ln
            tag, v = None, None
            vpos = 0
            while vpos < len(val):
                vkey, vpos = _read_varint(val, vpos)
                if vkey >> 3 == 1 and vkey & 7 == 2:
                    vln, vpos = _read_varint(val, vpos)
                    tag = val[vpos:vpos + vln].decode()
                    vpos += vln
                elif vkey >> 3 == 2 and vkey & 7 == 5:
                    (v,) = struct.unpack_from("<f", val, vpos)
                    vpos += 4
                else:  # skip anything else
                    wire = vkey & 7
                    if wire == 0:
                        _, vpos = _read_varint(val, vpos)
                    elif wire == 2:
                        vln, vpos = _read_varint(val, vpos)
                        vpos += vln
                    elif wire == 1:
                        vpos += 8
                    elif wire == 5:
                        vpos += 4
            if tag is not None and v is not None:
                scalars[tag] = v
        else:
            break
    return scalars
