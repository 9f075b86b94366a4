"""A codec of the port's own for flax's msgpack checkpoint format.

The JAX package writes its prior checkpoints (guidance/weights.py
``save_prior_ckpt``) and the LoRA trainer's state with
``flax.serialization.to_bytes``; the machine with the card has neither
flax nor msgpack, so the port reads and writes that format itself (as it
reads PNG in utils/png.py and .safetensors in guidance/weights.py).

The subset: msgpack maps with string keys (flax's state dicts; a tuple is
a map keyed "0", "1", …), nil, booleans, integers, floats, strings,
binaries and arrays; an ndarray is ExtType 1 whose payload is the msgpack
of ``(shape, dtype.name, C-order bytes)`` (flax 0.12
``_ndarray_to_bytes``), a numpy scalar ExtType 3 with the same payload.
``dumps`` writes each value in msgpack-python's encoding (the shortest
integer form, float64, bin for bytes), so a tree of numpy arrays gives
the bytes ``flax.serialization.msgpack_serialize`` gives.

Leaves read back as numpy arrays (ExtType 3 as a 0-d array); bfloat16,
which numpy lacks, is widened to float32 on read (exactly). Refused, with
a message: flax's ``__msgpack_chunked_array__`` form (it appears only for
leaves over 2**30 bytes), complex numbers (ExtType 2 and complex arrays),
and any other extension type.
"""
from __future__ import annotations

import struct
from typing import Any, Dict

import numpy as np

EXT_NDARRAY, EXT_COMPLEX, EXT_NPSCALAR = 1, 2, 3
MAX_LEAF_BYTES = 2 ** 30


# ---------------- encoder ----------------

def _pack_int(n: int, out: bytearray) -> None:
    if 0 <= n < 0x80:
        out.append(n)
    elif -32 <= n < 0:
        out.append(n & 0xFF)
    elif n >= 0:
        for tag, fmt, top in ((0xCC, ">B", 0xFF), (0xCD, ">H", 0xFFFF),
                              (0xCE, ">I", 0xFFFFFFFF),
                              (0xCF, ">Q", 0xFFFFFFFFFFFFFFFF)):
            if n <= top:
                out.append(tag)
                out += struct.pack(fmt, n)
                return
        raise ValueError(f"integer {n} does not fit msgpack's 64 bits")
    else:
        for tag, fmt, low in ((0xD0, ">b", -0x80), (0xD1, ">h", -0x8000),
                              (0xD2, ">i", -0x80000000),
                              (0xD3, ">q", -0x8000000000000000)):
            if n >= low:
                out.append(tag)
                out += struct.pack(fmt, n)
                return
        raise ValueError(f"integer {n} does not fit msgpack's 64 bits")


def _pack_len(n: int, out: bytearray, fix: int, fix_max: int, tags) -> None:
    """A length header: the fix form when n < fix_max, else the 8/16/32-bit
    tag (tags: (tag8 or None, tag16, tag32))."""
    if fix is not None and n < fix_max:
        out.append(fix | n)
        return
    for tag, fmt, top in zip(tags, (">B", ">H", ">I"),
                             (0xFF, 0xFFFF, 0xFFFFFFFF)):
        if tag is not None and n <= top:
            out.append(tag)
            out += struct.pack(fmt, n)
            return
    raise ValueError(f"length {n} does not fit msgpack's 32 bits")


def _pack_ext(code: int, data: bytes, out: bytearray) -> None:
    n = len(data)
    fixed = {1: 0xD4, 2: 0xD5, 4: 0xD6, 8: 0xD7, 16: 0xD8}
    if n in fixed:
        out.append(fixed[n])
    else:
        _pack_len(n, out, None, 0, (0xC7, 0xC8, 0xC9))
    out.append(code)
    out += data


def _array_payload(a: np.ndarray, where: str) -> bytes:
    if a.dtype.kind == "c":
        raise ValueError(f"{where}: complex arrays are not supported")
    if a.dtype.hasobject or a.dtype.fields is not None:
        raise ValueError(f"{where}: object and structured dtypes are not "
                         "supported")
    if a.nbytes > MAX_LEAF_BYTES:
        raise ValueError(f"{where}: a leaf over 2**30 bytes would need "
                         "flax's chunked-array form, which is not supported")
    return dumps([list(a.shape), a.dtype.name,
                  np.ascontiguousarray(a).tobytes()])


def _pack(x: Any, out: bytearray, where: str) -> None:
    if x is None:
        out.append(0xC0)
    elif x is True or x is False:
        out.append(0xC3 if x else 0xC2)
    elif isinstance(x, np.ndarray):
        _pack_ext(EXT_NDARRAY, _array_payload(x, where), out)
    elif isinstance(x, np.generic):
        _pack_ext(EXT_NPSCALAR, _array_payload(np.asarray(x), where), out)
    elif isinstance(x, int):
        _pack_int(x, out)
    elif isinstance(x, float):
        out.append(0xCB)
        out += struct.pack(">d", x)
    elif isinstance(x, complex):
        raise ValueError(f"{where}: complex numbers are not supported")
    elif isinstance(x, str):
        b = x.encode("utf-8")
        _pack_len(len(b), out, 0xA0, 32, (0xD9, 0xDA, 0xDB))
        out += b
    elif isinstance(x, (bytes, bytearray, memoryview)):
        b = bytes(x)
        _pack_len(len(b), out, None, 0, (0xC4, 0xC5, 0xC6))
        out += b
    elif isinstance(x, (list, tuple)):
        _pack_len(len(x), out, 0x90, 16, (None, 0xDC, 0xDD))
        for i, v in enumerate(x):
            _pack(v, out, f"{where}[{i}]")
    elif isinstance(x, dict):
        _pack_len(len(x), out, 0x80, 16, (None, 0xDE, 0xDF))
        for k, v in x.items():
            if not isinstance(k, str):
                raise ValueError(f"{where}: map key {k!r} is not a string")
            _pack(k, out, where)
            _pack(v, out, f"{where}/{k}")
    else:
        raise TypeError(f"{where}: cannot encode {type(x).__name__} "
                        "(numpy arrays, scalars, str, bytes, lists and "
                        "dicts with string keys)")


def dumps(tree: Any) -> bytes:
    """A tree of dicts (string keys), lists, numpy arrays and Python
    scalars → msgpack bytes, ndarrays as flax's ExtType 1."""
    out = bytearray()
    _pack(tree, out, "")
    return bytes(out)


# ---------------- decoder ----------------

class _Reader:
    def __init__(self, data: bytes, where: str):
        self.data, self.pos, self.where = memoryview(data), 0, where

    def take(self, n: int) -> memoryview:
        if self.pos + n > len(self.data):
            raise ValueError(f"{self.where}: truncated msgpack data")
        b = self.data[self.pos:self.pos + n]
        self.pos += n
        return b

    def unpack(self, fmt: str):
        return struct.unpack(fmt, self.take(struct.calcsize(fmt)))[0]

    def read(self) -> Any:
        tag = self.take(1)[0]
        if tag < 0x80:
            return tag
        if tag >= 0xE0:
            return tag - 0x100
        if 0x80 <= tag <= 0x8F:
            return self._map(tag & 0x0F)
        if 0x90 <= tag <= 0x9F:
            return [self.read() for _ in range(tag & 0x0F)]
        if 0xA0 <= tag <= 0xBF:
            return str(self.take(tag & 0x1F), "utf-8")
        simple = {0xC0: None, 0xC2: False, 0xC3: True}
        if tag in simple:
            return simple[tag]
        ints = {0xCC: ">B", 0xCD: ">H", 0xCE: ">I", 0xCF: ">Q",
                0xD0: ">b", 0xD1: ">h", 0xD2: ">i", 0xD3: ">q",
                0xCA: ">f", 0xCB: ">d"}
        if tag in ints:
            v = self.unpack(ints[tag])
            return float(v) if tag in (0xCA, 0xCB) else v
        lens = {0xC4: ">B", 0xC5: ">H", 0xC6: ">I", 0xD9: ">B", 0xDA: ">H",
                0xDB: ">I", 0xDC: ">H", 0xDD: ">I", 0xDE: ">H", 0xDF: ">I",
                0xC7: ">B", 0xC8: ">H", 0xC9: ">I"}
        if tag in lens:
            n = self.unpack(lens[tag])
            if tag in (0xC4, 0xC5, 0xC6):
                return bytes(self.take(n))
            if tag in (0xD9, 0xDA, 0xDB):
                return str(self.take(n), "utf-8")
            if tag in (0xDC, 0xDD):
                return [self.read() for _ in range(n)]
            if tag in (0xDE, 0xDF):
                return self._map(n)
            return self._ext(n)
        fixext = {0xD4: 1, 0xD5: 2, 0xD6: 4, 0xD7: 8, 0xD8: 16}
        if tag in fixext:
            return self._ext(fixext[tag])
        raise ValueError(f"{self.where}: msgpack tag 0x{tag:02x} is not "
                         "supported")

    def _map(self, n: int) -> Dict[str, Any]:
        out = {}
        for _ in range(n):
            k = self.read()
            if not isinstance(k, str):
                raise ValueError(f"{self.where}: map key {k!r} is not a "
                                 "string")
            out[k] = self.read()
        if "__msgpack_chunked_array__" in out:
            raise ValueError(f"{self.where}: flax's chunked-array form "
                             "(leaves over 2**30 bytes) is not supported")
        return out

    def _ext(self, n: int):
        code = self.unpack(">b")
        data = bytes(self.take(n))
        if code == EXT_NDARRAY:
            return _array(data, self.where)
        if code == EXT_NPSCALAR:
            return _array(data, self.where)[()]
        if code == EXT_COMPLEX:
            raise ValueError(f"{self.where}: complex numbers are not "
                             "supported")
        raise ValueError(f"{self.where}: msgpack extension type {code} is "
                         "not supported")


def _array(payload: bytes, where: str) -> np.ndarray:
    shape, name, buf = _Reader(payload, where).read()
    if isinstance(name, bytes):
        name = name.decode()
    if name == "bfloat16":
        u = np.frombuffer(buf, np.uint16).astype(np.uint32) << 16
        return u.view(np.float32).reshape(shape)
    dtype = np.dtype(name)
    if dtype.kind == "c":
        raise ValueError(f"{where}: complex arrays are not supported")
    return np.frombuffer(buf, dtype).reshape(shape).copy()


def loads(data: bytes, where: str = "msgpack") -> Any:
    """msgpack bytes → the tree, ndarrays as numpy arrays."""
    r = _Reader(data, where)
    tree = r.read()
    if r.pos != len(r.data):
        raise ValueError(f"{where}: {len(r.data) - r.pos} bytes after the "
                         "msgpack value")
    return tree


def save(path: str, tree: Any) -> None:
    with open(path, "wb") as f:
        f.write(dumps(tree))


def load(path: str) -> Any:
    with open(path, "rb") as f:
        return loads(f.read(), path)
