"""TFRecord files and tf.Example records, read and written without
tensorflow.

The port's copy of ``unboundednerfpytorch_tpu/data/tfrecord.py``, for the
Waymo Block-NeRF release (``data/preprocess.py``):

* the TFRecord framing: a stream of ``u64 length | u32 masked-crc32c(length)
  | payload | u32 masked-crc32c(payload)`` records, optionally the whole
  stream gzipped (the release's GZIP compression);
* a minimal tf.Example wire-format parser and encoder for the three feature
  kinds (BytesList, FloatList, Int64List); packed floats are decoded with
  ``np.frombuffer``.

Records are split by the port's copy of the JAX package's C++ framing
(``csrc/tfrecord_io.cpp``, built by the host's compiler at first use:
``ops/cuda/build.py::load_host``) wherever a host C++ compiler is found, as
the JAX package splits them; a build that fails raises. Without a compiler
the Python framing splits them, with the same records and the same errors
on a truncated or corrupted stream. ``FRAMINGS`` counts the streams split
by each (``"native"``, ``"python"``). The Python CRC-32C of a long payload
(a frame's per-pixel rays: some 15 MB at 640x960) runs in numpy, all of its
chunks a byte at a time together, instead of the whole payload a byte at a
time in Python.
"""

from __future__ import annotations

import collections
import ctypes
import gzip
import io
import struct

import numpy as np

_CRC_POLY = 0x82F63B78  # CRC-32C (Castagnoli), reflected
_CRC_MASK_DELTA = 0xA282EAD8


def _crc_table() -> list:
    table = []
    for i in range(256):
        c = i
        for _ in range(8):
            c = (c >> 1) ^ _CRC_POLY if c & 1 else c >> 1
        table.append(c)
    return table


_CRC_TABLE = _crc_table()


# from this many bytes on, the CRC runs in numpy over chunks of _CRC_CHUNK
_CRC_VECTOR_MIN = 1 << 16
_CRC_CHUNK = 4096


def _crc_loop(data, crc: int = 0xFFFFFFFF) -> int:
    table = _CRC_TABLE
    for b in data:
        crc = table[(crc ^ b) & 0xFF] ^ (crc >> 8)
    return crc


def _apply(cols, x):
    """The GF(2)-linear map whose image of bit i is ``cols[i]``, applied to
    each uint32 of ``x``."""
    out = np.zeros_like(x)
    for i, c in enumerate(cols):
        out ^= np.where((x >> np.uint32(i)) & np.uint32(1), np.uint32(c), np.uint32(0))
    return out


def _crc_vector(data: bytes) -> int:
    """The CRC register, from 0, after ``data``: each chunk's register in
    numpy (all chunks a byte at a time together), then the chunks joined in
    a tree, the left register carried over the right's zero bytes by the
    linear map of that many zero bytes. Leading zero bytes leave a register
    at 0, so the data is padded in front to whole chunks."""
    table = np.asarray(_CRC_TABLE, np.uint32)
    pad = (-len(data)) % _CRC_CHUNK
    cols_of_bytes = np.ascontiguousarray(
        np.frombuffer(b"\0" * pad + data, np.uint8).reshape(-1, _CRC_CHUNK).T)
    reg = np.zeros(cols_of_bytes.shape[1], np.uint32)
    for byte in cols_of_bytes:  # the j-th byte of every chunk
        reg = table[(reg ^ byte) & np.uint32(0xFF)] ^ (reg >> np.uint32(8))
    # the map of one zero byte, squared up to a chunk's, then once a level
    cols = [_crc_loop(b"\0", 1 << i) for i in range(32)]
    for _ in range(_CRC_CHUNK.bit_length() - 1):
        cols = [int(_apply(cols, np.uint32([c]))[0]) for c in cols]
    while reg.shape[0] > 1:
        if reg.shape[0] % 2:
            reg = np.concatenate([np.zeros(1, np.uint32), reg])
        reg = _apply(cols, reg[0::2]) ^ reg[1::2]
        cols = [int(_apply(cols, np.uint32([c]))[0]) for c in cols]
    return int(reg[0])


def crc32c(data: bytes) -> int:
    """The CRC-32C of ``data``; a long message through numpy (the register
    started at 0xFFFFFFFF is the one started at 0 on the data whose first
    four bytes are flipped)."""
    if len(data) < _CRC_VECTOR_MIN:
        return _crc_loop(data) ^ 0xFFFFFFFF
    head = (int.from_bytes(data[:4], "little") ^ 0xFFFFFFFF).to_bytes(4, "little")
    return _crc_vector(head + bytes(data[4:])) ^ 0xFFFFFFFF


def masked_crc(data: bytes) -> int:
    """The TFRecord mask of the CRC-32C: rotated right by 15, plus a delta."""
    crc = crc32c(data)
    return (((crc >> 15) | (crc << 17)) + _CRC_MASK_DELTA) & 0xFFFFFFFF


FRAMINGS: collections.Counter = collections.Counter()
# the native framing's codes for the Python framing's errors
_NATIVE_ERRORS = {-1: "truncated TFRecord header", -4: "truncated TFRecord payload",
                  -3: "TFRecord length crc mismatch", -5: "TFRecord payload crc mismatch"}


def native_framing():
    """The native framing's library, or None where no host C++ compiler is
    found (a compiler whose build fails raises)."""
    from unboundednerfpytorch_tpu_torch.ops.cuda import build

    if build.host_compiler() is None:
        return None
    lib = build.load_host("tfrecord_io")
    lib.tfr_split_records.restype = ctypes.c_longlong
    lib.tfr_split_records.argtypes = [ctypes.c_char_p, ctypes.c_size_t, ctypes.c_void_p,
                                      ctypes.c_void_p, ctypes.c_size_t, ctypes.c_int]
    return lib


def split_records_native(buf: bytes, verify_crc: bool = False, lib=None) -> list:
    """:func:`split_records_python`'s records and errors, split by the C++
    framing."""
    lib = lib or native_framing()
    buf = bytes(buf)
    cap = max(16, len(buf) // 32)
    while True:
        offs, lens = np.empty(cap, np.uint64), np.empty(cap, np.uint64)
        n = lib.tfr_split_records(buf, len(buf), offs.ctypes.data, lens.ctypes.data, cap,
                                  1 if verify_crc else 0)
        if n == -2:  # more records than room
            cap *= 4
            continue
        if n < 0:
            raise ValueError(_NATIVE_ERRORS.get(n, f"corrupt TFRecord stream (code {n})"))
        return list(zip(offs[:n].tolist(), lens[:n].tolist()))


def split_records(buf: bytes, verify_crc: bool = False) -> list:
    """(offset, length) of each record's payload in a TFRecord stream, split
    natively where a host compiler is found; ``ValueError`` on a truncated
    stream or, with ``verify_crc``, a CRC that does not match."""
    lib = native_framing()
    FRAMINGS["python" if lib is None else "native"] += 1
    if lib is None:
        return split_records_python(buf, verify_crc)
    return split_records_native(buf, verify_crc, lib)


def split_records_python(buf: bytes, verify_crc: bool = False) -> list:
    """(offset, length) of each record's payload, split in Python."""
    out, pos, n = [], 0, len(buf)
    while pos < n:
        if pos + 12 > n:
            raise ValueError("truncated TFRecord header")
        (length,) = struct.unpack_from("<Q", buf, pos)
        if verify_crc and masked_crc(buf[pos:pos + 8]) != struct.unpack_from("<I", buf, pos + 8)[0]:
            raise ValueError("TFRecord length crc mismatch")
        start = pos + 12
        if start + length + 4 > n:
            raise ValueError("truncated TFRecord payload")
        if verify_crc and masked_crc(buf[start:start + length]) != struct.unpack_from(
                "<I", buf, start + length)[0]:
            raise ValueError("TFRecord payload crc mismatch")
        out.append((start, length))
        pos = start + length + 4
    return out


def read_records(path: str, verify_crc: bool = False) -> list:
    """Every record payload of a TFRecord file, gzipped or not."""
    with open(path, "rb") as f:
        buf = f.read()
    if buf[:2] == b"\x1f\x8b":
        buf = gzip.decompress(buf)
    return [buf[o:o + n] for o, n in split_records(buf, verify_crc)]


def write_records(path: str, payloads, compress: bool = False) -> None:
    raw = io.BytesIO()
    for p in payloads:
        hdr = struct.pack("<Q", len(p))
        raw.write(hdr + struct.pack("<I", masked_crc(hdr)))
        raw.write(p + struct.pack("<I", masked_crc(p)))
    data = raw.getvalue()
    with open(path, "wb") as f:
        f.write(gzip.compress(data) if compress else data)


# ---------------------------------------------------------------------------
# the protobuf wire format of tf.Example


def _read_varint(buf: bytes, pos: int) -> tuple:
    result = shift = 0
    while True:
        b = buf[pos]
        pos += 1
        result |= (b & 0x7F) << shift
        if not b & 0x80:
            return result, pos
        shift += 7


def _fields(buf: bytes):
    """(field number, wire type, value) of each field: bytes for a
    length-delimited field, an int for a varint, the raw 4 or 8 bytes
    otherwise."""
    pos, n = 0, len(buf)
    while pos < n:
        key, pos = _read_varint(buf, pos)
        field, wt = key >> 3, key & 7
        if wt == 0:
            v, pos = _read_varint(buf, pos)
        elif wt == 2:
            ln, pos = _read_varint(buf, pos)
            v = buf[pos:pos + ln]
            pos += ln
        elif wt in (1, 5):
            width = 8 if wt == 1 else 4
            v = buf[pos:pos + width]
            pos += width
        else:
            raise ValueError(f"unsupported wire type {wt}")
        yield field, wt, v


def _parse_feature(buf: bytes):
    """Feature = oneof {1: BytesList, 2: FloatList, 3: Int64List}."""
    for field, _, v in _fields(buf):
        if field == 1:
            return [fv for f2, _, fv in _fields(v) if f2 == 1]
        if field == 2:  # packed or single fixed32 values alike
            vals = [np.frombuffer(fv, dtype="<f4") for f2, _, fv in _fields(v) if f2 == 1]
            return np.concatenate(vals) if vals else np.zeros((0,), np.float32)
        if field == 3:
            vals = []
            for f2, wt2, fv in _fields(v):
                if f2 != 1:
                    continue
                if wt2 != 2:
                    vals.append(fv)
                    continue
                p = 0
                while p < len(fv):
                    x, p = _read_varint(fv, p)
                    vals.append(x)
            return vals
    return None


def parse_example(payload: bytes) -> dict:
    """tf.Example -> {name: list of bytes | float32 array | list of ints}."""
    out = {}
    for field, _, v in _fields(payload):
        if field != 1:  # Example{1: Features}
            continue
        for f2, _, entry in _fields(v):
            if f2 != 1:  # Features{1: map<string, Feature>}
                continue
            name = feat = None
            for f3, _, mv in _fields(entry):
                if f3 == 1:
                    name = mv.decode("utf-8")
                elif f3 == 2:
                    feat = mv
            if name is not None and feat is not None:
                out[name] = _parse_feature(feat)
    return out


def _varint(x: int) -> bytes:
    out = bytearray()
    while True:
        b = x & 0x7F
        x >>= 7
        if not x:
            out.append(b)
            return bytes(out)
        out.append(b | 0x80)


def _ld(field: int, payload: bytes) -> bytes:
    return _varint(field << 3 | 2) + _varint(len(payload)) + payload


def encode_example(features: dict) -> bytes:
    """{name: bytes | [bytes] | float array | int array} -> tf.Example."""
    entries = b""
    for name, val in features.items():
        if isinstance(val, bytes):
            val = [val]
        if isinstance(val, (list, tuple)) and val and isinstance(val[0], bytes):
            fl = _ld(1, b"".join(_ld(1, b) for b in val))
        else:
            arr = np.asarray(val)
            if np.issubdtype(arr.dtype, np.floating):
                fl = _ld(2, _ld(1, arr.astype("<f4").tobytes()))
            else:
                fl = _ld(3, _ld(1, b"".join(_varint(int(x)) for x in arr.reshape(-1))))
        entries += _ld(1, _ld(1, name.encode()) + _ld(2, fl))
    return _ld(1, entries)
