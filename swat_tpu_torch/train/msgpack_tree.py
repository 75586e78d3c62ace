"""flax's msgpack tree format, read and written without flax or the msgpack
package (counterpart of ``flax.serialization.msgpack_serialize`` /
``msgpack_restore``, which ``swat_tpu/train/checkpoint.py:33-55`` uses for
its bundles).

What it covers: maps with str keys, str, int, float, bool, nil, bin,
arrays, and flax's ndarray extension (ext type 1, payload ``(shape,
dtype.name, bytes)`` packed with ``use_bin_type=True``).  It also reads ext
3 (a numpy scalar, packed as a 0-d ndarray) and the
``__msgpack_chunked_array__`` form flax writes for arrays over 2**30 bytes;
it refuses to write such an array (no model of the repo has a tensor that
large).  Map keys are written sorted at every level, as flax's copy
through ``jax.tree_util`` leaves them, so the same tree gives the same
bytes from both packages.  ``bfloat16`` arrays (no numpy dtype) are read as
float32, which holds them exactly.
"""

from __future__ import annotations

import struct
from typing import Any, BinaryIO, List

import numpy as np

EXT_NDARRAY = 1
EXT_NPSCALAR = 3
MAX_CHUNK_SIZE = 2 ** 30      # flax.serialization.MAX_CHUNK_SIZE
_CHUNKED = "__msgpack_chunked_array__"


# ---------------------------------------------------------------------------
# writing

def _int(n: int) -> bytes:
    if 0 <= n < 0x80:
        return bytes((n,))
    if -0x20 <= n < 0:
        return struct.pack(">b", n)
    if n > 0:
        for code, fmt, top in ((0xcc, ">B", 0xff), (0xcd, ">H", 0xffff),
                               (0xce, ">I", 0xffffffff),
                               (0xcf, ">Q", 0xffffffffffffffff)):
            if n <= top:
                return bytes((code,)) + struct.pack(fmt, n)
    else:
        for code, fmt, low in ((0xd0, ">b", -0x80), (0xd1, ">h", -0x8000),
                               (0xd2, ">i", -0x80000000),
                               (0xd3, ">q", -0x8000000000000000)):
            if n >= low:
                return bytes((code,)) + struct.pack(fmt, n)
    raise OverflowError(f"integer {n} does not fit msgpack")


def _sized(n: int, fix: int, fix_max: int, codes) -> bytes:
    """The header of a str / bin / array / map of length ``n``: the fixed
    form below ``fix_max`` (if the type has one), then 8/16/32-bit
    lengths."""
    if fix is not None and n <= fix_max:
        return bytes((fix | n,))
    for code, fmt, top in codes:
        if n <= top:
            return bytes((code,)) + struct.pack(fmt, n)
    raise OverflowError(f"length {n} does not fit msgpack")


def _str(s: str) -> bytes:
    b = s.encode("utf-8")
    return _sized(len(b), 0xa0, 31, ((0xd9, ">B", 0xff),
                                     (0xda, ">H", 0xffff),
                                     (0xdb, ">I", 0xffffffff))) + b


def _bin_header(n: int) -> bytes:
    return _sized(n, None, 0, ((0xc4, ">B", 0xff), (0xc5, ">H", 0xffff),
                               (0xc6, ">I", 0xffffffff)))


def _array_header(n: int) -> bytes:
    return _sized(n, 0x90, 15, ((0xdc, ">H", 0xffff),
                                (0xdd, ">I", 0xffffffff)))


def _map_header(n: int) -> bytes:
    return _sized(n, 0x80, 15, ((0xde, ">H", 0xffff),
                                (0xdf, ">I", 0xffffffff)))


def _ext_header(code: int, n: int) -> bytes:
    fixed = {1: 0xd4, 2: 0xd5, 4: 0xd6, 8: 0xd7, 16: 0xd8}
    if n in fixed:
        head = bytes((fixed[n],))
    else:
        head = _sized(n, None, 0, ((0xc7, ">B", 0xff), (0xc8, ">H", 0xffff),
                                   (0xc9, ">I", 0xffffffff)))
    return head + struct.pack(">b", code)


def _ndarray_parts(arr: np.ndarray, code: int) -> List[Any]:
    """flax's ``_ndarray_to_bytes`` inside an ext of type ``code``, as
    pieces: the headers, then the array's own buffer (not copied)."""
    if arr.dtype.hasobject or arr.dtype.isalignedstruct:
        raise ValueError("object and structured dtypes cannot be written")
    if not arr.flags.c_contiguous:
        arr = arr.copy(order="C")     # ascontiguousarray would make 0-d 1-d
    inner = (_array_header(3) + _array_header(arr.ndim)
             + b"".join(_int(int(d)) for d in arr.shape)
             + _str(arr.dtype.name) + _bin_header(arr.nbytes))
    data = memoryview(arr.reshape(-1).view(np.uint8))
    return [_ext_header(code, len(inner) + arr.nbytes), inner, data]


def _parts(obj, out: List[Any]) -> None:
    if obj is None:
        out.append(b"\xc0")
    elif obj is True or obj is False:
        out.append(b"\xc3" if obj else b"\xc2")
    elif type(obj) is int:
        out.append(_int(obj))
    elif type(obj) is float:
        out.append(b"\xcb" + struct.pack(">d", obj))
    elif type(obj) is str:
        out.append(_str(obj))
    elif type(obj) is bytes:
        out.append(_bin_header(len(obj)) + obj)
    elif type(obj) is list:
        out.append(_array_header(len(obj)))
        for item in obj:
            _parts(item, out)
    elif type(obj) is dict:
        if any(type(k) is not str for k in obj):
            raise TypeError("map keys must be str")
        out.append(_map_header(len(obj)))
        for key in sorted(obj):
            out.append(_str(key))
            _parts(obj[key], out)
    elif isinstance(obj, np.ndarray):
        if obj.nbytes > MAX_CHUNK_SIZE:
            raise ValueError(f"an array of {obj.nbytes} bytes is over flax's "
                             "chunk size; chunked arrays are not written")
        out.extend(_ndarray_parts(obj, EXT_NDARRAY))
    elif isinstance(obj, np.generic):
        out.extend(_ndarray_parts(np.asarray(obj), EXT_NPSCALAR))
    else:
        raise TypeError(f"cannot write {type(obj).__name__} as msgpack")


def write(f: BinaryIO, tree) -> None:
    """Writes ``tree`` (dicts with str keys, lists, numpy arrays and
    scalars, str / int / float / bool / None / bytes) to ``f`` in flax's
    msgpack form, array buffers written straight from memory."""
    parts: List[Any] = []
    _parts(tree, parts)
    for part in parts:
        f.write(part)


# ---------------------------------------------------------------------------
# reading

_FIXED = {0xcc: ">B", 0xcd: ">H", 0xce: ">I", 0xcf: ">Q", 0xd0: ">b",
          0xd1: ">h", 0xd2: ">i", 0xd3: ">q", 0xca: ">f", 0xcb: ">d"}
_LEN = {1: ">B", 2: ">H", 4: ">I"}


class _Reader:
    def __init__(self, buf):
        self.buf = memoryview(buf)
        self.pos = 0

    def take(self, n: int) -> memoryview:
        if self.pos + n > len(self.buf):
            raise ValueError("truncated msgpack data")
        view = self.buf[self.pos: self.pos + n]
        self.pos += n
        return view

    def num(self, fmt: str):
        return struct.unpack(fmt, self.take(struct.calcsize(fmt)))[0]

    def obj(self, raw: bool = False):
        code = self.take(1)[0]
        if code < 0x80:
            return code
        if code >= 0xe0:
            return code - 0x100
        if 0x80 <= code <= 0x8f:
            return self.map(code & 0x0f, raw)
        if 0x90 <= code <= 0x9f:
            return [self.obj(raw) for _ in range(code & 0x0f)]
        if 0xa0 <= code <= 0xbf:
            return self.text(code & 0x1f, raw)
        if code == 0xc0:
            return None
        if code in (0xc2, 0xc3):
            return code == 0xc3
        if code in _FIXED:
            return self.num(_FIXED[code])
        if code in (0xc4, 0xc5, 0xc6):
            data = self.take(self.num(_LEN[1 << (code - 0xc4)]))
            return data if raw else bytes(data)
        if code in (0xd9, 0xda, 0xdb):
            return self.text(self.num(_LEN[1 << (code - 0xd9)]), raw)
        if code in (0xdc, 0xdd):
            n = self.num(_LEN[2 << (code - 0xdc)])
            return [self.obj(raw) for _ in range(n)]
        if code in (0xde, 0xdf):
            return self.map(self.num(_LEN[2 << (code - 0xde)]), raw)
        if 0xd4 <= code <= 0xd8:
            return self.ext(1 << (code - 0xd4))
        if code in (0xc7, 0xc8, 0xc9):
            return self.ext(self.num(_LEN[1 << (code - 0xc7)]))
        raise ValueError(f"unknown msgpack type byte 0x{code:02x}")

    def text(self, n: int, raw: bool):
        data = self.take(n)
        return bytes(data) if raw else str(data, "utf-8")

    def map(self, n: int, raw: bool) -> dict:
        out = {}
        for _ in range(n):
            key = self.obj(raw)
            out[key] = self.obj(raw)
        return out

    def ext(self, n: int):
        code = self.num(">b")
        end = self.pos + n
        if code not in (EXT_NDARRAY, EXT_NPSCALAR):
            raise ValueError(f"unknown msgpack ext type {code}")
        shape, dtype, data = self.obj(raw=True)
        if self.pos != end:
            raise ValueError("malformed ndarray extension")
        arr = _ndarray(shape, dtype.decode(), data)
        return arr if code == EXT_NDARRAY else arr[()]


def _ndarray(shape, dtype: str, data: bytes) -> np.ndarray:
    if dtype == "bfloat16":
        bits = np.frombuffer(data, np.uint16).astype(np.uint32) << 16
        return bits.view(np.float32).reshape(shape)
    return np.frombuffer(data, np.dtype(dtype)).reshape(shape)


def _unchunk(tree):
    if isinstance(tree, dict):
        if _CHUNKED in tree:
            shape = tuple(tree["shape"][str(i)]
                          for i in range(len(tree["shape"])))
            chunks = [tree["chunks"][str(i)]
                      for i in range(len(tree["chunks"]))]
            return np.concatenate(chunks).reshape(shape)
        return {k: _unchunk(v) for k, v in tree.items()}
    return tree


def unpackb(data) -> Any:
    """The tree written by ``write`` or by flax's ``msgpack_serialize``;
    arrays are read-only views of ``data``."""
    reader = _Reader(data)
    tree = reader.obj()
    if reader.pos != len(reader.buf):
        raise ValueError("trailing bytes after the msgpack object")
    return _unchunk(tree)
