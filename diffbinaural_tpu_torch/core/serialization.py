"""The msgpack half of ``flax.serialization``, in pure Python and numpy.

The JAX package stores every checkpoint as flax msgpack.  The port needs no
more than torch and numpy, neither flax nor the ``msgpack`` package, so
this module reads and writes that format itself, byte for byte as flax
does:

  * maps, strings, ``bin``, arrays, ints, float64, nil and bool, each in its
    smallest encoding, as ``msgpack.packb`` picks it;
  * ``ExtType`` 1, an ndarray: a packed ``(shape, dtype name, C-order
    bytes)``; 3, a numpy scalar in the same encoding; 2, a complex
    ``(re, im)``;
  * leaves larger than ``MAX_CHUNK_SIZE`` bytes, split into a
    ``'__msgpack_chunked_array__'`` map of flat chunks on write and joined on
    read.

numpy has no ``bfloat16`` here.  A leaf whose dtype name is ``bfloat16``
decodes to a ``torch.bfloat16`` tensor (its bits read as int16 and viewed),
and a ``torch.bfloat16`` tensor encodes under that name, so such a leaf
survives a round trip bit for bit.  Every other array leaf decodes to a
writable numpy array, copied once out of the input.
"""

from __future__ import annotations

import struct
from typing import Any

import numpy as np
import torch

# flax's limit per leaf: msgpack objects stop at 2**31 - 1 bytes
MAX_CHUNK_SIZE = 2**30
CHUNKED = "__msgpack_chunked_array__"
EXT_NDARRAY, EXT_COMPLEX, EXT_NPSCALAR = 1, 2, 3

# type byte -> value, or -> struct format of the value or of the length
_CONSTANTS = {0xC0: None, 0xC2: False, 0xC3: True}
_NUMBERS = {0xCC: ">B", 0xCD: ">H", 0xCE: ">I", 0xCF: ">Q", 0xD0: ">b",
            0xD1: ">h", 0xD2: ">i", 0xD3: ">q", 0xCA: ">f", 0xCB: ">d"}
_STR_LENGTH = {0xD9: ">B", 0xDA: ">H", 0xDB: ">I"}
_BIN_LENGTH = {0xC4: ">B", 0xC5: ">H", 0xC6: ">I"}
_ARRAY_LENGTH = {0xDC: ">H", 0xDD: ">I"}
_MAP_LENGTH = {0xDE: ">H", 0xDF: ">I"}
_FIXEXT_LENGTH = {0xD4: 1, 0xD5: 2, 0xD6: 4, 0xD7: 8, 0xD8: 16}
_EXT_LENGTH = {0xC7: ">B", 0xC8: ">H", 0xC9: ">I"}
_FIXEXT_CODE = {n: b for b, n in _FIXEXT_LENGTH.items()}


class DecodeError(ValueError):
    """The bytes are not a msgpack document this module can read."""


# ------------------------------------------------------------------ trees


def to_state_dict(tree) -> Any:
    """flax's ``to_state_dict`` for plain containers: dicts keep their order
    with keys made strings, lists and tuples become ``{"0": ..., ...}``."""
    if isinstance(tree, dict):
        keys = [str(k) for k in tree]
        if len(set(keys)) != len(keys):
            raise ValueError("dict keys collide when made strings")
        return {str(k): to_state_dict(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return {str(i): to_state_dict(v) for i, v in enumerate(tree)}
    return tree


def from_state_dict(target, state) -> Any:
    """flax's ``from_state_dict`` for plain containers: ``state``'s values
    in ``target``'s structure; the keys of each dict must agree."""
    if isinstance(target, dict):
        if set(map(str, target)) != set(state):
            raise ValueError(
                f"target keys {sorted(map(str, target))} and state keys "
                f"{sorted(state)} do not match")
        return {k: from_state_dict(v, state[str(k)]) for k, v in target.items()}
    if isinstance(target, (list, tuple)):
        if len(target) != len(state):
            raise ValueError(f"target has {len(target)} entries, state "
                             f"{len(state)}")
        out = [from_state_dict(v, state[str(i)]) for i, v in enumerate(target)]
        return type(target)(out) if isinstance(target, tuple) else out
    return state


def _array_of(leaf):
    """(C-contiguous numpy array holding the leaf's bytes, dtype name)."""
    if isinstance(leaf, torch.Tensor):
        leaf = leaf.detach().cpu().contiguous()
        if leaf.dtype == torch.bfloat16:
            return leaf.view(torch.int16).numpy(), "bfloat16"
        leaf = leaf.numpy()
    arr = np.asarray(leaf, order="C")  # (ascontiguousarray makes 0-d 1-d)
    if arr.dtype.hasobject or arr.dtype.isalignedstruct:
        raise ValueError("object and structured dtypes cannot be serialized")
    return arr, arr.dtype.name


def _chunked(arr: np.ndarray, name: str) -> dict:
    """flax's ``_chunk``: a map of the shape and the flat chunks."""
    chunk = max(1, int(MAX_CHUNK_SIZE / arr.dtype.itemsize))
    flat = arr.reshape(-1)
    chunks = [_Named(flat[i: i + chunk], name)
              for i in range(0, flat.size, chunk)]
    return {CHUNKED: True,
            "shape": {str(i): d for i, d in enumerate(arr.shape)},
            "chunks": {str(i): c for i, c in enumerate(chunks)}}


class _Named:
    """An array and the dtype name to write it under."""

    __slots__ = ("arr", "name")

    def __init__(self, arr, name):
        self.arr, self.name = arr, name


# ---------------------------------------------------------------- encoder


class _Packer:
    """``msgpack.packb(tree, default=flax's ext packer, strict_types=True)``
    into one growing buffer."""

    def __init__(self):
        self.buf = bytearray()

    def pack(self, obj) -> None:
        buf = self.buf
        if obj is None:
            buf.append(0xC0)
        elif obj is True:
            buf.append(0xC3)
        elif obj is False:
            buf.append(0xC2)
        elif type(obj) is int:
            self._int(obj)
        elif type(obj) is float:
            buf.append(0xCB)
            buf += struct.pack(">d", obj)
        elif type(obj) is str:
            self._str(obj)
        elif type(obj) is bytes:
            self._bin_header(len(obj))
            buf += obj
        elif type(obj) is dict:
            self._map_header(len(obj))
            for k, v in obj.items():
                self.pack(k)
                self.pack(v)
        elif isinstance(obj, _Named):
            self._ndarray(EXT_NDARRAY, obj.arr, obj.name)
        elif isinstance(obj, (np.ndarray, torch.Tensor)):
            arr, name = _array_of(obj)
            if arr.nbytes > MAX_CHUNK_SIZE:
                self.pack(_chunked(arr, name))
            else:
                self._ndarray(EXT_NDARRAY, arr, name)
        elif isinstance(obj, np.generic):
            arr, name = _array_of(np.asarray(obj))
            self._ndarray(EXT_NPSCALAR, arr, name)
        elif type(obj) is complex:
            inner = _Packer()
            inner._array_header(2)
            inner.pack(obj.real)
            inner.pack(obj.imag)
            self._ext_header(EXT_COMPLEX, len(inner.buf))
            buf += inner.buf
        else:
            raise TypeError(f"cannot serialize {type(obj).__name__}")

    def _int(self, x: int) -> None:
        buf = self.buf
        if -32 <= x < 128:
            buf += struct.pack(">b", x) if x < 0 else bytes((x,))
        elif x >= 0:
            for lim, code, fmt in ((1 << 8, 0xCC, ">B"), (1 << 16, 0xCD, ">H"),
                                   (1 << 32, 0xCE, ">I"), (1 << 64, 0xCF, ">Q")):
                if x < lim:
                    buf.append(code)
                    buf += struct.pack(fmt, x)
                    return
            raise OverflowError("integer too large for msgpack")
        else:
            for lim, code, fmt in ((1 << 7, 0xD0, ">b"), (1 << 15, 0xD1, ">h"),
                                   (1 << 31, 0xD2, ">i"), (1 << 63, 0xD3, ">q")):
                if x >= -lim:
                    buf.append(code)
                    buf += struct.pack(fmt, x)
                    return
            raise OverflowError("integer too small for msgpack")

    def _sized(self, n: int, fix_base, fix_max, codes) -> None:
        """A header: fix form below ``fix_max``, else 8/16/32-bit length
        codes (None where the type has no such form)."""
        buf = self.buf
        if fix_base is not None and n < fix_max:
            buf.append(fix_base | n)
            return
        for lim, code, fmt in zip((1 << 8, 1 << 16, 1 << 32), codes,
                                  (">B", ">H", ">I")):
            if code is not None and n < lim:
                buf.append(code)
                buf += struct.pack(fmt, n)
                return
        raise ValueError("object too large for msgpack")

    def _str(self, s: str) -> None:
        raw = s.encode("utf-8")
        self._sized(len(raw), 0xA0, 32, (0xD9, 0xDA, 0xDB))
        self.buf += raw

    def _bin_header(self, n: int) -> None:
        self._sized(n, None, 0, (0xC4, 0xC5, 0xC6))

    def _array_header(self, n: int) -> None:
        self._sized(n, 0x90, 16, (None, 0xDC, 0xDD))

    def _map_header(self, n: int) -> None:
        self._sized(n, 0x80, 16, (None, 0xDE, 0xDF))

    def _ext_header(self, code: int, n: int) -> None:
        if n in _FIXEXT_CODE:
            self.buf.append(_FIXEXT_CODE[n])
        else:
            self._sized(n, None, 0, (0xC7, 0xC8, 0xC9))
        self.buf += struct.pack(">b", code)

    def _ndarray(self, code: int, arr: np.ndarray, name: str) -> None:
        """flax's ``_ndarray_to_bytes`` inside an ExtType, written straight
        into the buffer: the payload's length is known before its bytes."""
        head = _Packer()
        head._array_header(3)
        head._array_header(len(arr.shape))
        for d in arr.shape:
            head._int(int(d))
        head._str(name)
        head._bin_header(arr.nbytes)
        self._ext_header(code, len(head.buf) + arr.nbytes)
        self.buf += head.buf
        self.buf += memoryview(arr.reshape(-1).view(np.uint8))


def serialize(tree) -> bytearray:
    """msgpack bytes of a state dict (dicts of arrays or tensors, numpy
    scalars, int, float, complex, str, bytes, bool, None: what
    ``to_state_dict`` leaves), in one buffer."""
    packer = _Packer()
    packer.pack(tree)
    return packer.buf


def to_bytes(tree) -> bytes:
    """``flax.serialization.to_bytes`` for trees of plain containers."""
    return bytes(serialize(to_state_dict(tree)))


# ---------------------------------------------------------------- decoder


class _Unpacker:
    """``msgpack.unpackb(data, ext_hook=flax's ext unpacker, raw=False)``
    over a memoryview."""

    def __init__(self, data):
        self.mv = memoryview(data).cast("B")
        self.pos = 0

    def take(self, n: int) -> memoryview:
        if self.pos + n > len(self.mv):
            raise DecodeError("unexpected end of data")
        out = self.mv[self.pos: self.pos + n]
        self.pos += n
        return out

    def _num(self, fmt: str):
        return struct.unpack(fmt, self.take(struct.calcsize(fmt)))[0]

    def unpack(self, raw: bool = False):
        b = self.take(1)[0]
        if b <= 0x7F:
            return b
        if b >= 0xE0:
            return b - 0x100
        if 0x80 <= b <= 0x8F:
            return self._map(b & 0x0F, raw)
        if 0x90 <= b <= 0x9F:
            return [self.unpack(raw) for _ in range(b & 0x0F)]
        if 0xA0 <= b <= 0xBF:
            return self._text(b & 0x1F, raw)
        if b in _CONSTANTS:
            return _CONSTANTS[b]
        if b in _NUMBERS:
            return self._num(_NUMBERS[b])
        if b in _STR_LENGTH:
            return self._text(self._num(_STR_LENGTH[b]), raw)
        if b in _BIN_LENGTH:
            return bytes(self.take(self._num(_BIN_LENGTH[b])))
        if b in _ARRAY_LENGTH:
            return [self.unpack(raw) for _ in range(self._num(_ARRAY_LENGTH[b]))]
        if b in _MAP_LENGTH:
            return self._map(self._num(_MAP_LENGTH[b]), raw)
        if b in _FIXEXT_LENGTH:
            return self._ext(_FIXEXT_LENGTH[b])
        if b in _EXT_LENGTH:
            return self._ext(self._num(_EXT_LENGTH[b]))
        raise DecodeError(f"unknown msgpack type byte 0x{b:02x}")

    def _text(self, n: int, raw: bool):
        data = bytes(self.take(n))
        if raw:
            return data
        try:
            return data.decode("utf-8")
        except UnicodeDecodeError as e:
            raise DecodeError(str(e)) from None

    def _map(self, n: int, raw: bool) -> dict:
        out = {}
        for _ in range(n):
            k = self.unpack(raw)
            if not isinstance(k, (str, bytes)):
                raise DecodeError(f"map key of type {type(k).__name__}")
            out[k] = self.unpack(raw)
        if CHUNKED in out:
            return _unchunk(out)
        return out

    def _ext(self, n: int):
        code = self._num(">b")
        payload = self.take(n)
        if code in (EXT_NDARRAY, EXT_NPSCALAR):
            arr = _ndarray_from(payload)
            return arr if code == EXT_NDARRAY else arr[()]
        if code == EXT_COMPLEX:
            re, im = _Unpacker(payload).unpack()
            return complex(re, im)
        raise DecodeError(f"unknown ExtType code {code}")


def _ndarray_from(payload: memoryview):
    """flax's ``_ndarray_from_bytes``, copying the data once into a writable
    array (a torch tensor for bfloat16)."""
    inner = _Unpacker(payload)
    b = inner.take(1)[0]
    if b != 0x93:
        raise DecodeError("ndarray payload is not a 3-tuple")
    shape = inner.unpack(raw=True)
    name = inner.unpack(raw=True)
    tag = inner.take(1)[0]
    if tag not in _BIN_LENGTH:
        raise DecodeError("ndarray payload holds no bin")
    data = inner.take(inner._num(_BIN_LENGTH[tag]))
    if not isinstance(shape, list) or not isinstance(name, bytes):
        raise DecodeError("malformed ndarray payload")
    name = name.decode("ascii")
    try:  # bfloat16: its bits as int16
        dtype = np.dtype(np.int16 if name == "bfloat16" else name)
    except TypeError:
        raise DecodeError(f"unknown dtype {name!r}") from None
    if len(data) != int(np.prod(shape, dtype=np.int64)) * dtype.itemsize:
        raise DecodeError(f"ndarray of {shape} {name} has {len(data)} bytes")
    arr = np.frombuffer(data, dtype).reshape(shape).copy()
    if name == "bfloat16":
        return torch.from_numpy(arr).view(torch.bfloat16)
    return arr


def _unchunk(d: dict):
    """flax's ``_unchunk``: the flat chunks joined and reshaped."""
    shape = tuple(d["shape"][str(i)] for i in range(len(d["shape"])))
    chunks = [d["chunks"][str(i)] for i in range(len(d["chunks"]))]
    if isinstance(chunks[0], torch.Tensor):
        return torch.cat(chunks).reshape(shape)
    return np.concatenate(chunks).reshape(shape)


def msgpack_restore(data) -> Any:
    """``flax.serialization.msgpack_restore``: the tree of dicts, lists,
    arrays and scalars the bytes hold."""
    unpacker = _Unpacker(data)
    try:
        out = unpacker.unpack()
    except DecodeError:
        raise
    except (struct.error, KeyError, ValueError, RuntimeError) as e:
        # a payload that decodes but does not fit (a chunk map, a shape)
        raise DecodeError(f"{type(e).__name__}: {e}") from None
    if unpacker.pos != len(unpacker.mv):
        raise DecodeError(f"extra data after {unpacker.pos} bytes")
    return out


def from_bytes(target, data) -> Any:
    """``flax.serialization.from_bytes`` for trees of plain containers."""
    return from_state_dict(target, msgpack_restore(data))
