"""The msgpack subset that ``flax.serialization`` writes, without flax or msgpack.

The JAX package writes its checkpoints with ``flax.serialization.to_bytes``:
msgpack of a tree of maps with string keys, whose leaves are arrays, numpy
scalars and Python scalars. This module encodes and decodes exactly that
subset, byte for byte as flax 0.12 with msgpack 1.x does
(``msgpack.packb(tree, default=..., strict_types=True)``, bin type on):

* nil, bool, int (the smallest of fixint, uint8..64, int8..64), float
  (always float64), str (fixstr, str8/16/32), bin (bin8/16/32), array
  (fixarray, array16/32; a tuple packs as an array, and arrays decode as
  lists) and map (fixmap, map16/32; in insertion order both ways, which byte
  identity with flax depends on);
* flax's ndarray ext, code 1: a msgpack array ``[shape, dtype name, raw C
  bytes]`` (e.g. a scalar int32 leaf is ``c7 0e 01 93 90 a5 'int32' c4 04
  ...``), packed as fixext 1/2/4/8/16 when the payload has one of those
  lengths and as ext8/16/32 otherwise;
* the numpy-scalar ext, code 3: the same payload, for an ``np.generic``.

Everything else is refused with an error that names it: flax's complex ext
(code 2), any other ext code, and flax's chunked-array map
(``__msgpack_chunked_array__``), which flax writes only for leaves over
2**30 bytes. Decoded leaves are writable numpy arrays, except ``bfloat16``,
which numpy cannot name: it becomes a torch tensor (``torch.frombuffer``).
A torch tensor leaf packs as the ndarray ext, ``bfloat16`` included.
"""

from __future__ import annotations

import struct

import numpy as np
import torch

EXT_NDARRAY, EXT_COMPLEX, EXT_NPSCALAR = 1, 2, 3
CHUNKED_MARKER = "__msgpack_chunked_array__"


class MsgpackError(ValueError):
    """Bytes that are not the msgpack subset of flax checkpoints."""


# ---- encoding ----------------------------------------------------------------------


def _pack_int(x: int, out: list) -> None:
    if 0 <= x < 0x80:
        out.append(struct.pack("B", x))
    elif x >= 0:
        for limit, code, fmt in ((0x100, 0xCC, ">B"), (0x10000, 0xCD, ">H"),
                                 (0x100000000, 0xCE, ">I"), (1 << 64, 0xCF, ">Q")):
            if x < limit:
                out.append(bytes([code]) + struct.pack(fmt, x))
                return
        raise MsgpackError(f"int {x} does not fit in 64 bits")
    elif x >= -32:
        out.append(struct.pack("b", x))
    else:
        for limit, code, fmt in ((-0x80, 0xD0, ">b"), (-0x8000, 0xD1, ">h"),
                                 (-0x80000000, 0xD2, ">i"), (-(1 << 63), 0xD3, ">q")):
            if x >= limit:
                out.append(bytes([code]) + struct.pack(fmt, x))
                return
        raise MsgpackError(f"int {x} does not fit in 64 bits")


def _pack_len(n: int, small: tuple | None, codes: tuple, out: list) -> None:
    """A length header: the fix form under ``small = (limit, base)``, else
    the 8-, 16- or 32-bit form (``codes``; None where msgpack has none)."""
    if small is not None and n < small[0]:
        out.append(bytes([small[1] | n]))
        return
    for limit, code, fmt in zip((0x100, 0x10000, 0x100000000), codes, (">B", ">H", ">I")):
        if code is not None and n < limit:
            out.append(bytes([code]) + struct.pack(fmt, n))
            return
    raise MsgpackError(f"a length of {n} does not fit in msgpack")


def _array_payload(arr) -> bytes:
    """flax's ``_ndarray_to_bytes``: ``packb((shape, dtype name, C bytes))``."""
    if isinstance(arr, torch.Tensor):
        t = arr.detach().cpu().contiguous()
        if t.dtype == torch.bfloat16:
            shape, name, raw = tuple(t.shape), "bfloat16", t.view(torch.int16).numpy().tobytes()
        else:
            a = t.numpy()
            shape, name, raw = a.shape, a.dtype.name, a.tobytes("C")
    else:
        if arr.dtype.hasobject or arr.dtype.isalignedstruct:
            raise MsgpackError(f"dtype {arr.dtype} cannot be serialized")
        shape, name, raw = arr.shape, arr.dtype.name, arr.tobytes("C")
    return packb((tuple(int(s) for s in shape), name, raw))


def _pack_ext(code: int, payload: bytes, out: list) -> None:
    n = len(payload)
    fixext = {1: 0xD4, 2: 0xD5, 4: 0xD6, 8: 0xD7, 16: 0xD8}
    if n in fixext:
        out.append(bytes([fixext[n], code]))
    else:
        _pack_len(n, None, (0xC7, 0xC8, 0xC9), out)
        out.append(bytes([code]))
    out.append(payload)


def _pack(x, out: list) -> None:
    t = type(x)
    if x is None:
        out.append(b"\xc0")
    elif t is bool:
        out.append(b"\xc3" if x else b"\xc2")
    elif t is int:
        _pack_int(x, out)
    elif t is float:
        out.append(b"\xcb" + struct.pack(">d", x))
    elif t is str:
        raw = x.encode("utf-8")
        _pack_len(len(raw), (32, 0xA0), (0xD9, 0xDA, 0xDB), out)
        out.append(raw)
    elif t in (bytes, bytearray, memoryview):
        raw = bytes(x)
        _pack_len(len(raw), None, (0xC4, 0xC5, 0xC6), out)
        out.append(raw)
    elif t in (list, tuple):
        _pack_len(len(x), (16, 0x90), (None, 0xDC, 0xDD), out)
        for v in x:
            _pack(v, out)
    elif t is dict:
        _pack_len(len(x), (16, 0x80), (None, 0xDE, 0xDF), out)
        for k, v in x.items():
            _pack(k, out)
            _pack(v, out)
    elif isinstance(x, (np.ndarray, torch.Tensor)):
        _pack_ext(EXT_NDARRAY, _array_payload(x), out)
    elif isinstance(x, np.generic):
        _pack_ext(EXT_NPSCALAR, _array_payload(np.asarray(x)), out)
    else:
        raise MsgpackError(f"cannot serialize a {t.__name__} leaf")


def packb(tree) -> bytes:
    """msgpack bytes of ``tree``, as ``flax.serialization.msgpack_serialize``
    writes them for a tree without chunked leaves."""
    out: list = []
    _pack(tree, out)
    return b"".join(out)


# ---- decoding ----------------------------------------------------------------------


class _Reader:
    def __init__(self, data):
        self.buf = memoryview(data).cast("B")
        self.pos = 0

    def take(self, n: int) -> memoryview:
        end = self.pos + n
        if end > len(self.buf):
            raise MsgpackError(f"truncated msgpack data: {n} bytes wanted at offset {self.pos}, "
                               f"{len(self.buf) - self.pos} left")
        view = self.buf[self.pos:end]
        self.pos = end
        return view

    def unpack(self, fmt: str):
        return struct.unpack(fmt, self.take(struct.calcsize(fmt)))[0]


_LEN_FMT = {0: ">B", 1: ">H", 2: ">I"}


def _dtype_of(name: str):
    if name == "bfloat16":
        return torch.bfloat16
    try:
        return np.dtype(name)
    except TypeError as e:
        raise MsgpackError(f"unknown array dtype {name!r}") from e


def _array_from_payload(payload: memoryview):
    """flax's ``_ndarray_from_bytes``, as a writable copy."""
    fields = _Reader(payload)
    value = _read(fields, raw=True)
    if fields.pos != len(payload) or not (isinstance(value, list) and len(value) == 3):
        raise MsgpackError("malformed ndarray ext: not [shape, dtype, bytes]")
    shape, name, raw = value
    dtype = _dtype_of(bytes(name).decode("ascii"))
    shape = tuple(int(s) for s in shape)
    if dtype is torch.bfloat16:
        t = torch.frombuffer(bytearray(raw), dtype=torch.bfloat16) if len(raw) else \
            torch.empty(0, dtype=torch.bfloat16)
        return t.reshape(shape)
    return np.frombuffer(raw, dtype=dtype).reshape(shape).copy()


def _ext(code: int, payload: memoryview):
    if code == EXT_NDARRAY:
        return _array_from_payload(payload)
    if code == EXT_NPSCALAR:
        arr = _array_from_payload(payload)
        return arr.reshape(()) if isinstance(arr, torch.Tensor) else arr[()]
    if code == EXT_COMPLEX:
        raise MsgpackError("msgpack ext 2 (flax's complex number) is not supported")
    raise MsgpackError(f"msgpack ext type {code} is not supported")


def _read(r: _Reader, raw: bool = False):
    """One object. ``raw``: str stays bytes (flax's inner ndarray payload)."""
    b = r.take(1)[0]
    if b <= 0x7F:
        return b
    if b >= 0xE0:
        return b - 0x100
    if 0x80 <= b <= 0x8F:
        return _read_map(r, b & 0x0F, raw)
    if 0x90 <= b <= 0x9F:
        return [_read(r, raw) for _ in range(b & 0x0F)]
    if 0xA0 <= b <= 0xBF:
        return _str(r.take(b & 0x1F), raw)
    if b == 0xC0:
        return None
    if b in (0xC2, 0xC3):
        return b == 0xC3
    if 0xC4 <= b <= 0xC6:
        return bytes(r.take(r.unpack(_LEN_FMT[b - 0xC4])))
    if 0xC7 <= b <= 0xC9:
        n = r.unpack(_LEN_FMT[b - 0xC7])
        code = r.unpack(">b")
        return _ext(code, r.take(n))
    if b == 0xCA:
        return r.unpack(">f")
    if b == 0xCB:
        return r.unpack(">d")
    if 0xCC <= b <= 0xD3:
        return r.unpack((">B", ">H", ">I", ">Q", ">b", ">h", ">i", ">q")[b - 0xCC])
    if 0xD4 <= b <= 0xD8:
        code = r.unpack(">b")
        return _ext(code, r.take(1 << (b - 0xD4)))
    if 0xD9 <= b <= 0xDB:
        return _str(r.take(r.unpack(_LEN_FMT[b - 0xD9])), raw)
    if b in (0xDC, 0xDD):
        return [_read(r, raw) for _ in range(r.unpack(">H" if b == 0xDC else ">I"))]
    if b in (0xDE, 0xDF):
        return _read_map(r, r.unpack(">H" if b == 0xDE else ">I"), raw)
    raise MsgpackError(f"byte 0x{b:02x} at offset {r.pos - 1} is not msgpack")


def _str(view: memoryview, raw: bool):
    if raw:
        return bytes(view)
    try:
        return str(view, "utf-8")
    except UnicodeDecodeError as e:
        raise MsgpackError(f"invalid utf-8 in a msgpack str: {e}") from e


def _read_map(r: _Reader, n: int, raw: bool) -> dict:
    out = {}
    for _ in range(n):
        key = _read(r, raw)
        if key == CHUNKED_MARKER:
            raise MsgpackError(f"flax's chunked array ('{CHUNKED_MARKER}', a leaf over 2**30 "
                               "bytes) is not supported")
        if isinstance(key, (list, dict)):
            raise MsgpackError(f"a msgpack map key of type {type(key).__name__}")
        out[key] = _read(r, raw)
    return out


def unpackb(data) -> object:
    """The tree of msgpack ``data``, as ``flax.serialization.msgpack_restore``
    reads it (maps as dicts in their order, arrays as lists, the two flax
    exts as arrays and numpy scalars). Trailing bytes are an error."""
    r = _Reader(data)
    tree = _read(r)
    if r.pos != len(r.buf):
        raise MsgpackError(f"{len(r.buf) - r.pos} trailing bytes after the msgpack object")
    return tree
