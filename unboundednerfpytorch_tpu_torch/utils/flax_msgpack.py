"""flax's msgpack checkpoint encoding, read and written without flax or the
``msgpack`` package.

The JAX package writes its checkpoints with ``flax.serialization.to_bytes``:
the state dict of a pytree (dataclass fields and dict keys as map keys,
lists and tuples as maps keyed ``"0"``, ``"1"``, ..., ``None`` as nil)
packed by msgpack, each array an ext of type 1 whose payload is itself the
msgpack array ``[shape, dtype name, C-order bytes]``, a numpy scalar an ext
of type 3 with the same payload, and an array of more than
``MAX_CHUNK_SIZE`` bytes split into the map ``{"__msgpack_chunked_array__":
True, "shape": {"0": d0, ...}, "chunks": {"0": flat piece, ...}}``.

:func:`unpack` decodes such bytes. Arrays are ``np.frombuffer`` views of the
buffer it is given (no copy: pass a writable buffer, such as the
``bytearray`` that :func:`read` fills, for writable arrays); a ``bfloat16``
array, which numpy lacks, is a ``torch.bfloat16`` tensor viewing the same
bytes. A chunked array is joined into one array. :func:`pack` and
:func:`write` encode a tree of dicts, ``None``, bools, ints, floats,
strings, numpy arrays and scalars and CPU tensors to the bytes that
``to_bytes`` gives the same tree, arrays written from their own memory.
"""

from __future__ import annotations

import io
import struct

import numpy as np
import torch

MAX_CHUNK_SIZE = 2**30  # flax's: an array of more bytes is written in chunks
CHUNKED = "__msgpack_chunked_array__"
EXT_NDARRAY, EXT_NPSCALAR = 1, 3
_TORCH_NAMES = {torch.float32: "float32", torch.int32: "int32", torch.bool: "bool"}


# ---------------------------------------------------------------------------
# decoding


class _Reader:
    def __init__(self, buf):
        self.buf = memoryview(buf).cast("B")
        self.pos = 0

    def take(self, n: int) -> memoryview:
        if self.pos + n > len(self.buf):
            raise ValueError("msgpack: truncated data")
        out = self.buf[self.pos:self.pos + n]
        self.pos += n
        return out

    def uint(self, n: int) -> int:
        return int.from_bytes(self.take(n), "big")

    def sint(self, n: int) -> int:
        return int.from_bytes(self.take(n), "big", signed=True)

    def obj(self):
        b = self.take(1)[0]
        if b <= 0x7F:
            return b
        if b >= 0xE0:
            return b - 0x100
        if 0x80 <= b <= 0x8F:
            return self.map(b & 0x0F)
        if 0x90 <= b <= 0x9F:
            return [self.obj() for _ in range(b & 0x0F)]
        if 0xA0 <= b <= 0xBF:
            return self.str(b & 0x1F)
        if b == 0xC0:
            return None
        if b in (0xC2, 0xC3):
            return b == 0xC3
        if b in (0xC4, 0xC5, 0xC6):  # bin 8/16/32
            return self.take(self.uint(1 << (b - 0xC4)))
        if b in (0xC7, 0xC8, 0xC9):  # ext 8/16/32
            n = self.uint(1 << (b - 0xC7))
            return self.ext(self.sint(1), n)
        if b == 0xCA:
            return struct.unpack(">f", self.take(4))[0]
        if b == 0xCB:
            return struct.unpack(">d", self.take(8))[0]
        if 0xCC <= b <= 0xCF:  # uint 8-64
            return self.uint(1 << (b - 0xCC))
        if 0xD0 <= b <= 0xD3:  # int 8-64
            return self.sint(1 << (b - 0xD0))
        if 0xD4 <= b <= 0xD8:  # fixext 1-16
            code = self.sint(1)
            return self.ext(code, 1 << (b - 0xD4))
        if b in (0xD9, 0xDA, 0xDB):  # str 8/16/32
            return self.str(self.uint(1 << (b - 0xD9)))
        if b in (0xDC, 0xDD):  # array 16/32
            return [self.obj() for _ in range(self.uint(2 if b == 0xDC else 4))]
        if b in (0xDE, 0xDF):  # map 16/32
            return self.map(self.uint(2 if b == 0xDE else 4))
        raise ValueError(f"msgpack: unknown type byte 0x{b:02x}")

    def str(self, n: int) -> str:
        return str(self.take(n), "utf-8")

    def map(self, n: int) -> dict:
        out = {}
        for _ in range(n):
            key = self.obj()
            out[key] = self.obj()
        return out

    def ext(self, code: int, n: int):
        data = self.take(n)
        if code not in (EXT_NDARRAY, EXT_NPSCALAR):
            raise ValueError(f"msgpack: ext type {code} is not an array")
        shape, name, raw = _Reader(data).obj()
        arr = _array(raw, name, shape)
        return arr if code == EXT_NDARRAY else arr[()]


def _array(raw: memoryview, name: str, shape):
    if name == "bfloat16":
        bits = np.frombuffer(raw, np.int16).reshape(shape)
        return torch.from_numpy(bits).view(torch.bfloat16)
    return np.frombuffer(raw, np.dtype(name)).reshape(shape)


def _unchunk(tree):
    if not isinstance(tree, dict):
        return tree
    if tree.get(CHUNKED) is True:
        shape = tuple(tree["shape"][str(i)] for i in range(len(tree["shape"])))
        chunks = [tree["chunks"][str(i)] for i in range(len(tree["chunks"]))]
        if isinstance(chunks[0], torch.Tensor):
            return torch.cat(chunks).reshape(shape)
        return np.concatenate(chunks).reshape(shape)
    return {k: _unchunk(v) for k, v in tree.items()}


def unpack(buf):
    """The tree that ``flax.serialization.msgpack_restore`` gives of ``buf``
    (arrays view ``buf``; a ``bfloat16`` one as a ``torch.bfloat16``
    tensor)."""
    reader = _Reader(buf)
    tree = reader.obj()
    if reader.pos != len(reader.buf):
        raise ValueError(f"msgpack: {len(reader.buf) - reader.pos} bytes after the object")
    return _unchunk(tree)


def read(path: str):
    """:func:`unpack` of a file, read once into a writable buffer."""
    with open(path, "rb") as f:
        size = f.seek(0, io.SEEK_END)
        f.seek(0)
        buf = bytearray(size)
        if f.readinto(buf) != size:
            raise ValueError(f"{path}: short read")
    return unpack(buf)


def lists(tree):
    """A state dict's maps keyed ``"0"`` .. ``"n-1"`` as lists, at every
    level (flax's layout of a tuple or list)."""
    if not isinstance(tree, dict):
        return tree
    if tree and all(isinstance(k, str) and k.isdigit() for k in tree) and \
            sorted(map(int, tree)) == list(range(len(tree))):
        return [lists(tree[str(i)]) for i in range(len(tree))]
    return {k: lists(v) for k, v in tree.items()}


# ---------------------------------------------------------------------------
# encoding


def _int(v: int) -> bytes:
    if v < -(1 << 5):
        if v < -(1 << 15):
            return b"\xd3" + v.to_bytes(8, "big", signed=True) if v < -(1 << 31) else \
                b"\xd2" + v.to_bytes(4, "big", signed=True)
        return b"\xd1" + v.to_bytes(2, "big", signed=True) if v < -(1 << 7) else \
            b"\xd0" + v.to_bytes(1, "big", signed=True)
    if v < (1 << 7):
        return v.to_bytes(1, "big", signed=True)
    for code, n in ((0xCC, 1), (0xCD, 2), (0xCE, 4), (0xCF, 8)):
        if v < (1 << (8 * n)):
            return bytes([code]) + v.to_bytes(n, "big")
    raise OverflowError(f"msgpack: int {v} too large")


def _sized(n: int, small: int | None, fix: int, codes) -> bytes:
    """A header of ``n`` elements or bytes: ``fix | n`` under ``small``,
    else the first code of ``codes`` (8-, 16-, 32-bit lengths) that holds it."""
    if small is not None and n < small:
        return bytes([fix | n])
    for code, width in codes:
        if n < (1 << (8 * width)):
            return bytes([code]) + n.to_bytes(width, "big")
    raise OverflowError(f"msgpack: length {n} too large")


def _str(s: str) -> bytes:
    raw = s.encode("utf-8")
    return _sized(len(raw), 32, 0xA0, ((0xD9, 1), (0xDA, 2), (0xDB, 4))) + raw


def _bin_header(n: int) -> bytes:
    return _sized(n, None, 0, ((0xC4, 1), (0xC5, 2), (0xC6, 4)))


def _ext_header(code: int, n: int) -> bytes:
    fixed = {1: 0xD4, 2: 0xD5, 4: 0xD6, 8: 0xD7, 16: 0xD8}
    if n in fixed:
        return bytes([fixed[n], code])
    for head, width in ((0xC7, 1), (0xC8, 2), (0xC9, 4)):
        if n < (1 << (8 * width)):
            return bytes([head]) + n.to_bytes(width, "big") + bytes([code])
    raise OverflowError(f"msgpack: ext of {n} bytes too large")


def _as_numpy(x):
    """(C-contiguous numpy array, dtype name) of an array leaf."""
    if isinstance(x, torch.Tensor):
        t = x.detach().cpu().contiguous()
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy(), "bfloat16"
        if t.dtype not in _TORCH_NAMES:
            raise TypeError(f"msgpack: tensor dtype {t.dtype} is not written")
        return t.numpy(), _TORCH_NAMES[t.dtype]
    arr = np.require(x, requirements="C")  # keeps a 0-d array 0-d
    if arr.dtype.hasobject or arr.dtype.isalignedstruct:
        raise TypeError(f"msgpack: dtype {arr.dtype} is not written")
    return arr, arr.dtype.name


def _write_array(out, x, code: int) -> None:
    arr, name = _as_numpy(x)
    head = (b"\x93" + _sized(len(arr.shape), 16, 0x90, ((0xDC, 2), (0xDD, 4)))
            + b"".join(_int(int(d)) for d in arr.shape) + _str(name) + _bin_header(arr.nbytes))
    out.write(_ext_header(code, len(head) + arr.nbytes) + head)
    if arr.nbytes:
        out.write(memoryview(arr.reshape(-1).view(np.uint8)))


def _is_array(x) -> bool:
    return isinstance(x, (np.ndarray, torch.Tensor))


def _nbytes(x) -> int:
    return x.numel() * x.element_size() if isinstance(x, torch.Tensor) else x.nbytes


def _chunk(x) -> dict:
    """flax's ``_chunk``: the flat array in pieces of ``MAX_CHUNK_SIZE``
    bytes or fewer."""
    flat = x.reshape(-1)
    size = max(1, int(MAX_CHUNK_SIZE / (x.element_size() if isinstance(x, torch.Tensor)
                                        else x.dtype.itemsize)))
    chunks = [flat[i:i + size] for i in range(0, flat.shape[0], size)]
    return {CHUNKED: True, "shape": {str(i): int(d) for i, d in enumerate(x.shape)},
            "chunks": {str(i): c for i, c in enumerate(chunks)}}


def _write(out, x) -> None:
    if x is None:
        out.write(b"\xc0")
    elif x is True or x is False:
        out.write(b"\xc3" if x else b"\xc2")
    elif isinstance(x, dict):
        out.write(_sized(len(x), 16, 0x80, ((0xDE, 2), (0xDF, 4))))
        for k, v in x.items():
            if not isinstance(k, str):
                raise TypeError(f"msgpack: key {k!r} is not a string")
            out.write(_str(k))
            if _is_array(v) and _nbytes(v) > MAX_CHUNK_SIZE:
                v = _chunk(v)
            _write(out, v)
    elif _is_array(x):
        _write_array(out, x, EXT_NDARRAY)
    elif isinstance(x, np.generic):
        _write_array(out, np.asarray(x), EXT_NPSCALAR)
    elif isinstance(x, int):
        out.write(_int(x))
    elif isinstance(x, float):
        out.write(b"\xcb" + struct.pack(">d", x))
    elif isinstance(x, str):
        out.write(_str(x))
    elif isinstance(x, (list, tuple)):
        out.write(_sized(len(x), 16, 0x90, ((0xDC, 2), (0xDD, 4))))
        for v in x:
            _write(out, v)
    elif isinstance(x, bytes):
        out.write(_bin_header(len(x)) + x)
    else:
        raise TypeError(f"msgpack: {type(x).__name__} is not written")


def write(f, tree) -> None:
    """Write ``tree`` to the binary file ``f`` as ``flax.serialization``'s
    ``msgpack_serialize`` encodes it."""
    if _is_array(tree) and _nbytes(tree) > MAX_CHUNK_SIZE:
        tree = _chunk(tree)
    _write(f, tree)


def pack(tree) -> bytes:
    """The bytes of :func:`write`."""
    out = io.BytesIO()
    write(out, tree)
    return out.getvalue()
