"""The JAX package's checkpoint files (flax msgpack), read and written with
plain Python and numpy: no ``jax``, ``flax`` or ``msgpack``.

``flax.serialization.to_bytes`` turns a tree into a state dict (every dict,
list and tuple becomes a dict with string keys; a tuple's keys are "0",
"1", ...; a named tuple's are its fields) and packs it with msgpack, leaves
as msgpack natives or as flax's extension types
(``flax.serialization._MsgpackExtType``):

- 1 ``ndarray``: the msgpack array ``(shape, dtype name, C-order bytes)``;
- 2 ``native_complex``: the msgpack array ``(real, imag)``;
- 3 ``npscalar``: a numpy scalar, as ``ndarray`` with shape ``()``.

An array above :data:`MAX_CHUNK_SIZE` bytes is stored as a dict
``{"__msgpack_chunked_array__": True, "shape": {...}, "chunks": {...}}`` of
flat chunks. :func:`read` returns what ``flax.serialization.msgpack_restore``
returns (dicts, lists, Python scalars, numpy arrays and scalars), with one
difference: numpy has no bfloat16, so bfloat16 leaves are widened to float32
(exactly: the 16 bits become the high half of an f32). :func:`write` packs a
tree as ``to_bytes`` does, byte for byte.
"""

from __future__ import annotations

import math
import os
import struct
from typing import Any, Iterator, Union

import numpy as np

#: flax's ``serialization.MAX_CHUNK_SIZE``: arrays above this many bytes are
#: split into chunks of at most this many bytes.
MAX_CHUNK_SIZE = 2 ** 30

EXT_NDARRAY, EXT_COMPLEX, EXT_NPSCALAR = 1, 2, 3
CHUNKED = "__msgpack_chunked_array__"

# msgpack's type bytes outside the fix ranges: constants, numbers (with
# their big-endian struct formats) and sized objects (with their lengths').
_CONSTANTS = {0xC0: None, 0xC2: False, 0xC3: True}
_NUMBERS = {0xCA: ">f", 0xCB: ">d", 0xCC: ">B", 0xCD: ">H", 0xCE: ">I", 0xCF: ">Q",
            0xD0: ">b", 0xD1: ">h", 0xD2: ">i", 0xD3: ">q"}
_SIZED = {0xC4: ("bin", ">B"), 0xC5: ("bin", ">H"), 0xC6: ("bin", ">I"),
          0xC7: ("ext", ">B"), 0xC8: ("ext", ">H"), 0xC9: ("ext", ">I"),
          0xD9: ("str", ">B"), 0xDA: ("str", ">H"), 0xDB: ("str", ">I"),
          0xDC: ("array", ">H"), 0xDD: ("array", ">I"),
          0xDE: ("map", ">H"), 0xDF: ("map", ">I")}


# ---- reading ----


class _Reader:
    """One pass over msgpack bytes; arrays are views of the buffer."""

    def __init__(self, buf, name: str):
        self.buf = memoryview(buf).cast("B")
        self.pos = 0
        self.name = name

    def fail(self, what: str, at=None):
        raise ValueError(f"{self.name}: {what} at byte offset {self.pos if at is None else at}")

    def take(self, n: int) -> memoryview:
        end = self.pos + n
        if end > len(self.buf):
            self.fail(f"truncated: {n} bytes needed, {len(self.buf) - self.pos} left")
        out = self.buf[self.pos:end]
        self.pos = end
        return out

    def unpack(self, fmt: str):
        return struct.unpack(fmt, self.take(struct.calcsize(fmt)))[0]

    def obj(self) -> Any:
        at = self.pos
        b = self.unpack(">B")
        if b <= 0x7F:
            return b
        if b >= 0xE0:
            return b - 0x100
        if 0x80 <= b <= 0x8F:
            return self.mapping(b & 0x0F, at)
        if 0x90 <= b <= 0x9F:
            return [self.obj() for _ in range(b & 0x0F)]
        if 0xA0 <= b <= 0xBF:
            return self.text(b & 0x1F)
        if b in _CONSTANTS:
            return _CONSTANTS[b]
        if b in _NUMBERS:
            return self.unpack(_NUMBERS[b])
        if 0xD4 <= b <= 0xD8:
            return self.ext(1 << (b - 0xD4), at)
        if b not in _SIZED:
            self.fail(f"byte 0x{b:02x} starts no msgpack object", at)
        kind, fmt = _SIZED[b]
        n = self.unpack(fmt)
        if kind == "bin":
            return bytes(self.take(n))
        if kind == "str":
            return self.text(n)
        if kind == "array":
            return [self.obj() for _ in range(n)]
        if kind == "map":
            return self.mapping(n, at)
        return self.ext(n, at)

    def text(self, n: int) -> str:
        at = self.pos
        try:
            return str(self.take(n), "utf-8")
        except UnicodeDecodeError:
            self.fail("a string that is not UTF-8", at)

    def mapping(self, n: int, at: int) -> dict:
        out = {}
        for _ in range(n):
            key = self.obj()
            if isinstance(key, (list, dict)):
                self.fail("a map key that is a container", at)
            out[key] = self.obj()
        return out

    def ext(self, n: int, at: int):
        code = self.unpack(">b")
        end = self.pos + n
        if end > len(self.buf):
            self.fail(f"truncated: an extension of {n} bytes", at)
        if code == EXT_COMPLEX:
            val = self.obj()
            if not (isinstance(val, list) and len(val) == 2):
                self.fail("a complex number that is not (real, imag)", at)
            val = complex(val[0], val[1])
        elif code in (EXT_NDARRAY, EXT_NPSCALAR):
            val = self.ndarray(at)
            if code == EXT_NPSCALAR:
                val = val[()]
        else:
            self.fail(f"extension type {code}, which flax does not write", at)
        if self.pos != end:
            self.fail(f"an extension of {n} bytes that holds {self.pos - end + n}", at)
        return val

    def ndarray(self, at: int) -> np.ndarray:
        """An array extension's ``(shape, dtype name, bytes)``; the array is
        a view of the buffer."""
        if self.unpack(">B") != 0x93:
            self.fail("an array extension that is not (shape, dtype, bytes)", at)
        shape, name = self.obj(), self.obj()
        tag = self.unpack(">B")
        if not (isinstance(shape, list) and all(isinstance(s, int) and s >= 0 for s in shape)
                and isinstance(name, str) and _SIZED.get(tag, ("",))[0] == "bin"):
            self.fail("a malformed array extension", at)
        data = self.take(self.unpack(_SIZED[tag][1]))
        return _array(data, name, shape, lambda what: self.fail(what, at))


def _array(data, name: str, shape, fail) -> np.ndarray:
    count = math.prod(shape)
    if name == "bfloat16":
        if len(data) != 2 * count:
            fail(f"a bfloat16 array of shape {tuple(shape)} with {len(data)} bytes")
        bits = np.frombuffer(data, np.uint16).astype(np.uint32) << 16
        return bits.view(np.float32).reshape(shape)
    try:
        dtype = np.dtype(name)
    except TypeError:
        fail(f"an array of unknown dtype {name!r}")
    if dtype.hasobject or len(data) != dtype.itemsize * count:
        fail(f"a {name} array of shape {tuple(shape)} with {len(data)} bytes")
    return np.frombuffer(data, dtype).reshape(shape)


def _unchunk(d: dict, fail) -> np.ndarray:
    try:
        shape = tuple(d["shape"][str(i)] for i in range(len(d["shape"])))
        chunks = [d["chunks"][str(i)] for i in range(len(d["chunks"]))]
        return np.concatenate(chunks).reshape(shape)
    except (KeyError, TypeError, ValueError) as e:
        fail(f"a malformed chunked array ({e})")


def _unchunk_leaves(d, fail):
    """flax's ``_unchunk_array_leaves_in_place``."""
    if isinstance(d, dict):
        if CHUNKED in d:
            return _unchunk(d, fail)
        for k, v in d.items():
            d[k] = _unchunk_leaves(v, fail)
    return d


def read(source: Union[str, os.PathLike, bytes, bytearray, memoryview]) -> Any:
    """The tree in a flax msgpack file (a path) or in its bytes. A path is
    read once into one buffer, and every array leaf is a view of it.
    Raises ``ValueError``, naming the file and the byte offset, on a
    truncated or malformed input."""
    if isinstance(source, (bytes, bytearray, memoryview)):
        buf, name = source, "<bytes>"
    else:
        name = os.fspath(source)
        with open(name, "rb") as f:
            buf = bytearray(os.fstat(f.fileno()).st_size)
            if f.readinto(buf) != len(buf):
                raise ValueError(f"{name}: the file changed size while it was read")
    r = _Reader(buf, name)
    tree = r.obj()
    if r.pos != len(r.buf):
        r.fail(f"{len(r.buf) - r.pos} bytes after the end of the tree")
    return _unchunk_leaves(tree, lambda what: r.fail(what, 0))


# ---- writing ----


def _header(n: int, fix_max: int, fix_tag: int, tags) -> bytes:
    """The header of a sized object: a fix form below ``fix_max``, else the
    smallest of ``tags`` (8-, 16- and 32-bit lengths; None where msgpack has
    no such form)."""
    if n < fix_max:
        return bytes([fix_tag | n])
    for tag, fmt, limit in zip(tags, (">B", ">H", ">I"), (1 << 8, 1 << 16, 1 << 32)):
        if tag is not None and n < limit:
            return bytes([tag]) + struct.pack(fmt, n)
    raise ValueError(f"object of length {n} is too long for msgpack")


def _int(v: int) -> bytes:
    if 0 <= v < 128 or -32 <= v < 0:
        return struct.pack(">b" if v < 0 else ">B", v)
    if v >= 0:
        for tag, fmt, limit in ((0xCC, ">B", 1 << 8), (0xCD, ">H", 1 << 16),
                                (0xCE, ">I", 1 << 32), (0xCF, ">Q", 1 << 64)):
            if v < limit:
                return bytes([tag]) + struct.pack(fmt, v)
    else:
        for tag, fmt, limit in ((0xD0, ">b", 1 << 7), (0xD1, ">h", 1 << 15),
                                (0xD2, ">i", 1 << 31), (0xD3, ">q", 1 << 63)):
            if v >= -limit:
                return bytes([tag]) + struct.pack(fmt, v)
    raise OverflowError(f"integer {v} does not fit msgpack's 64 bits")


def _str(s: str) -> bytes:
    raw = s.encode("utf-8")
    return _header(len(raw), 32, 0xA0, (0xD9, 0xDA, 0xDB)) + raw


def _bin_header(n: int) -> bytes:
    return _header(n, 0, 0, (0xC4, 0xC5, 0xC6))


def _ext_header(code: int, n: int) -> bytes:
    fixed = {1: 0xD4, 2: 0xD5, 4: 0xD6, 8: 0xD7, 16: 0xD8}
    head = bytes([fixed[n]]) if n in fixed else _header(n, 0, 0, (0xC7, 0xC8, 0xC9))
    return head + struct.pack(">b", code)


def _ndarray(code: int, arr: np.ndarray) -> Iterator[bytes]:
    if arr.dtype.hasobject or arr.dtype.isalignedstruct:
        raise ValueError("object and structured dtypes cannot be written")
    arr = np.asarray(arr, order="C")  # (ascontiguousarray makes a 0-d array 1-d)
    data = memoryview(arr).cast("B") if arr.size else b""
    shape = _header(arr.ndim, 16, 0x90, (None, 0xDC, 0xDD)) + b"".join(_int(s) for s in arr.shape)
    inner = b"\x93" + shape + _str(arr.dtype.name) + _bin_header(len(data))
    yield _ext_header(code, len(inner) + len(data)) + inner
    yield data


def _state_dict(x):
    """flax's ``to_state_dict`` for plain containers."""
    if isinstance(x, tuple) and hasattr(x, "_fields"):
        return {k: _state_dict(getattr(x, k)) for k in x._fields}
    if isinstance(x, (list, tuple)):
        return {str(i): _state_dict(v) for i, v in enumerate(x)}
    if isinstance(x, dict):
        out = {str(k): _state_dict(v) for k, v in x.items()}
        if len(out) != len(x):
            raise ValueError(f"dict keys without a unique string form: {list(x)}")
        return out
    return x


def _chunked(arr: np.ndarray) -> dict:
    size = max(1, int(MAX_CHUNK_SIZE / arr.dtype.itemsize))
    flat = arr.reshape(-1)
    return {CHUNKED: True, "shape": {str(i): s for i, s in enumerate(arr.shape)},
            "chunks": {str(j): flat[i:i + size]
                       for j, i in enumerate(range(0, flat.size, size))}}


def _encode(x) -> Iterator[bytes]:
    if isinstance(x, np.ndarray) and x.size * x.dtype.itemsize > MAX_CHUNK_SIZE:
        x = _chunked(x)
    if x is None:
        yield b"\xc0"
    elif x is True or x is False:
        yield b"\xc3" if x else b"\xc2"
    elif type(x) is int:
        yield _int(x)
    elif type(x) is float:
        yield b"\xcb" + struct.pack(">d", x)
    elif type(x) is str:
        yield _str(x)
    elif type(x) is bytes:
        yield _bin_header(len(x)) + x
    elif type(x) is complex:
        body = b"\x92\xcb" + struct.pack(">d", x.real) + b"\xcb" + struct.pack(">d", x.imag)
        yield _ext_header(EXT_COMPLEX, len(body)) + body
    elif type(x) is dict:
        yield _header(len(x), 16, 0x80, (None, 0xDE, 0xDF))
        for k, v in x.items():
            yield from _encode(k)
            yield from _encode(v)
    elif isinstance(x, np.ndarray):
        yield from _ndarray(EXT_NDARRAY, x)
    elif isinstance(x, np.generic):
        yield from _ndarray(EXT_NPSCALAR, np.asarray(x))
    else:
        raise TypeError(f"cannot write a {type(x).__name__} into a flax msgpack file")


def write(path: Union[str, os.PathLike], tree: Any) -> None:
    """Write ``tree`` (dicts, lists, tuples and named tuples of numpy arrays
    and scalars, Python scalars, strings and bytes) as
    ``flax.serialization.to_bytes`` would, through a temporary file and a
    rename, as the JAX package's ``save_params`` does. Array bytes go to the
    file without a copy."""
    path = os.fspath(path)
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        for piece in _encode(_state_dict(tree)):
            f.write(piece)
    os.replace(tmp, path)
