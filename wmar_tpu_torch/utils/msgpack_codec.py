"""A reader and writer for the msgpack that ``flax.serialization`` writes.

The JAX package stores parameter trees with ``flax.serialization`` (plain
msgpack plus an ext type for arrays). The port reads and writes the same
bytes without flax, jax, msgpack or ml_dtypes:

* plain types: nil, bool, ints, float32/64, str, bin, array and map, in
  their fix/8/16/32(/64) forms;
* ext type 1, an array: a nested msgpack of ``(shape, dtype name, C-order
  bytes)``; ext type 3, a numpy scalar in the same encoding;
* chunked leaves: an array over ``MAX_CHUNK_SIZE`` bytes is written as
  ``{'__msgpack_chunked_array__': True, 'shape': {...}, 'chunks': {...}}``
  of flat chunks, as ``flax/serialization.py`` does (msgpack caps a bin at
  2**32 - 1 bytes).

Arrays come back as CPU ``torch`` tensors (``bfloat16`` too: numpy has no
bf16), made by ``torch.frombuffer`` over a slice of the input and cloned,
so no byte is copied in Python. Numpy scalars come back as numpy scalars
(a bf16 one as a 0-d tensor). :func:`serialize` writes what
``flax.serialization.msgpack_serialize`` writes for the same tree: dict keys
sorted (JAX's tree order), lists as msgpack arrays, the smallest form of
every int, str and container, Python floats as float64. Tensors and numpy
arrays are both written as ext type 1; numpy scalars as ext type 3. No
pickle anywhere.
"""

from __future__ import annotations

import struct
from typing import Any, BinaryIO, Callable, List

import numpy as np
import torch

MAX_CHUNK_SIZE = 2**30
CHUNKED_KEY = "__msgpack_chunked_array__"
_EXT_NDARRAY, _EXT_NPSCALAR = 1, 3

_TORCH_DTYPES = {
    "bool": torch.bool, "uint8": torch.uint8, "int8": torch.int8, "int16": torch.int16,
    "int32": torch.int32, "int64": torch.int64, "float16": torch.float16, "bfloat16": torch.bfloat16,
    "float32": torch.float32, "float64": torch.float64, "complex64": torch.complex64,
    "complex128": torch.complex128, "uint16": torch.uint16, "uint32": torch.uint32, "uint64": torch.uint64,
}
_DTYPE_NAMES = {v: k for k, v in _TORCH_DTYPES.items()}
Writer = Callable[[Any], Any]  # takes each piece of the output in order


# ---------------------------------------------------------------------------
# Writing
# ---------------------------------------------------------------------------


def _pack_int(write: Writer, v: int) -> None:
    if 0 <= v < 0x80:
        write(bytes((v,)))
    elif -32 <= v < 0:
        write(struct.pack("b", v))
    elif v >= 0:
        for code, fmt, top in ((0xCC, ">B", 0xFF), (0xCD, ">H", 0xFFFF), (0xCE, ">I", 0xFFFFFFFF),
                               (0xCF, ">Q", 0xFFFFFFFFFFFFFFFF)):
            if v <= top:
                write(bytes((code,)) + struct.pack(fmt, v))
                return
        raise OverflowError(f"int {v} does not fit msgpack's uint64")
    else:
        for code, fmt, low in ((0xD0, ">b", -0x80), (0xD1, ">h", -0x8000), (0xD2, ">i", -0x80000000),
                               (0xD3, ">q", -0x8000000000000000)):
            if v >= low:
                write(bytes((code,)) + struct.pack(fmt, v))
                return
        raise OverflowError(f"int {v} does not fit msgpack's int64")


def _pack_len(write: Writer, n: int, fix_base, fix_max, codes) -> None:
    """The header of a str, bin, array or map of ``n`` items: the fix form
    where ``fix_base`` is given and ``n <= fix_max``, else the 8/16/32-bit
    length forms in ``codes``."""
    if fix_base is not None and n <= fix_max:
        write(bytes((fix_base | n,)))
        return
    for code, fmt, top in zip(codes, (">B", ">H", ">I"), (0xFF, 0xFFFF, 0xFFFFFFFF)):
        if code is not None and n <= top:
            write(bytes((code,)) + struct.pack(fmt, n))
            return
    raise OverflowError(f"msgpack length {n} past 2**32 - 1")


def _pack_bin(write: Writer, data) -> None:
    _pack_len(write, len(data), None, 0, (0xC4, 0xC5, 0xC6))
    write(data)


def _pack_ext(write: Writer, code: int, parts) -> None:
    """An ext of type ``code`` whose data is ``parts`` joined (each written
    as it is, so an array's buffer is never copied into a larger one)."""
    n = sum(len(p) for p in parts)
    fixed = {1: 0xD4, 2: 0xD5, 4: 0xD6, 8: 0xD7, 16: 0xD8}
    if n in fixed:
        write(bytes((fixed[n], code)))
    else:
        _pack_len(write, n, None, 0, (0xC7, 0xC8, 0xC9))
        write(bytes((code,)))
    for p in parts:
        write(p)


def _array_parts(shape, dtype_name: str, data) -> tuple:
    """The nested msgpack of an array, ``[shape, dtype name, bytes]``, as
    (its head, the bytes)."""
    out: List[bytes] = [b"\x93"]
    _pack_len(out.append, len(shape), 0x90, 15, (None, 0xDC, 0xDD))
    for d in shape:
        _pack_int(out.append, int(d))
    _pack_str(out.append, dtype_name)
    _pack_len(out.append, len(data), None, 0, (0xC4, 0xC5, 0xC6))
    return b"".join(out), data


def _pack_str(write: Writer, s: str) -> None:
    b = s.encode("utf-8")
    _pack_len(write, len(b), 0xA0, 31, (0xD9, 0xDA, 0xDB))
    write(b)


def _tensor_bytes(t: torch.Tensor):
    """The C-order bytes of a tensor, as one buffer (no Python-level loop)."""
    t = t.detach().to("cpu").contiguous().reshape(-1)
    if t.dtype == torch.bool:
        t = t.to(torch.uint8)
    return memoryview(t.view(torch.uint8).numpy()) if t.numel() else b""


def _leaf_nbytes(x) -> int:
    if isinstance(x, torch.Tensor):
        return x.numel() * x.element_size()
    return x.size * x.dtype.itemsize


def _chunk(x) -> dict:
    """A chunked leaf, as ``flax.serialization._chunk`` builds it."""
    itemsize = x.element_size() if isinstance(x, torch.Tensor) else x.dtype.itemsize
    size = max(1, int(MAX_CHUNK_SIZE / itemsize))
    flat = x.reshape(-1)
    n = flat.numel() if isinstance(flat, torch.Tensor) else flat.size
    return {CHUNKED_KEY: True, "shape": {str(i): int(d) for i, d in enumerate(x.shape)},
            "chunks": {str(j): flat[i: i + size] for j, i in enumerate(range(0, n, size))}}


def _pack(write: Writer, x: Any, sort_keys: bool) -> None:
    if x is None:
        write(b"\xc0")
    elif x is True:
        write(b"\xc3")
    elif x is False:
        write(b"\xc2")
    elif isinstance(x, (torch.Tensor, np.ndarray)):
        if _leaf_nbytes(x) > MAX_CHUNK_SIZE:
            _pack(write, _chunk(x), sort_keys=False)
        elif isinstance(x, torch.Tensor):
            if x.dtype not in _DTYPE_NAMES:
                raise TypeError(f"no msgpack dtype name for {x.dtype}")
            _pack_ext(write, _EXT_NDARRAY, _array_parts(x.shape, _DTYPE_NAMES[x.dtype], _tensor_bytes(x)))
        else:
            _pack_ext(write, _EXT_NDARRAY, _array_parts(x.shape, x.dtype.name, np.ascontiguousarray(x).tobytes()))
    elif isinstance(x, np.generic):
        a = np.asarray(x)
        _pack_ext(write, _EXT_NPSCALAR, _array_parts(a.shape, a.dtype.name, a.tobytes()))
    elif isinstance(x, int):
        _pack_int(write, x)
    elif isinstance(x, float):
        write(b"\xcb" + struct.pack(">d", x))
    elif isinstance(x, str):
        _pack_str(write, x)
    elif isinstance(x, (bytes, bytearray, memoryview)):
        _pack_bin(write, x)
    elif isinstance(x, (list, tuple)):
        _pack_len(write, len(x), 0x90, 15, (None, 0xDC, 0xDD))
        for v in x:
            _pack(write, v, sort_keys)
    elif isinstance(x, dict):
        _pack_len(write, len(x), 0x80, 15, (None, 0xDE, 0xDF))
        items = x.items()
        if sort_keys and all(isinstance(k, str) for k in x):
            items = sorted(items)
        for k, v in items:
            _pack(write, k, sort_keys)
            _pack(write, v, sort_keys)
    else:
        raise TypeError(f"cannot write a {type(x).__name__} as msgpack")


def serialize(tree: Any, sort_keys: bool = True) -> bytes:
    """msgpack bytes of ``tree`` (dicts, lists, tuples, scalars, strings,
    tensors, numpy arrays and scalars), as ``flax.serialization.
    msgpack_serialize`` writes them: dict keys sorted (``sort_keys=False``
    keeps insertion order), arrays over ``MAX_CHUNK_SIZE`` bytes chunked."""
    out: List[bytes] = []
    _pack(out.append, tree, sort_keys)
    return b"".join(out)


def dump(tree: Any, f: BinaryIO, sort_keys: bool = True) -> None:
    """:func:`serialize`'s bytes written to the binary file ``f`` piece by
    piece: each array's buffer goes to the file as it is, so writing holds
    no second copy of the tree."""
    _pack(f.write, tree, sort_keys)


# ---------------------------------------------------------------------------
# Reading
# ---------------------------------------------------------------------------


class _Reader:
    def __init__(self, buf):
        self.buf = memoryview(buf)
        self.pos = 0

    def take(self, n: int) -> memoryview:
        if self.pos + n > len(self.buf):
            raise ValueError(f"msgpack data ends at {len(self.buf)}, {n} bytes wanted at {self.pos}")
        v = self.buf[self.pos: self.pos + n]
        self.pos += n
        return v

    def unpack(self, fmt: str, n: int):
        return struct.unpack(fmt, self.take(n))[0]

    def value(self) -> Any:
        c = self.take(1)[0]
        if c <= 0x7F:
            return c
        if c >= 0xE0:
            return c - 0x100
        if 0x80 <= c <= 0x8F:
            return self.map(c & 0x0F)
        if 0x90 <= c <= 0x9F:
            return [self.value() for _ in range(c & 0x0F)]
        if 0xA0 <= c <= 0xBF:
            return str(self.take(c & 0x1F), "utf-8")
        if c == 0xC0:
            return None
        if c in (0xC2, 0xC3):
            return c == 0xC3
        if c in (0xC4, 0xC5, 0xC6):
            return self.take(self.unpack(*((">B", 1), (">H", 2), (">I", 4))[c - 0xC4]))
        if c in (0xC7, 0xC8, 0xC9):
            n = self.unpack(*((">B", 1), (">H", 2), (">I", 4))[c - 0xC7])
            return self.ext(n)
        if c == 0xCA:
            return self.unpack(">f", 4)
        if c == 0xCB:
            return self.unpack(">d", 8)
        if 0xCC <= c <= 0xD3:
            fmt, n = ((">B", 1), (">H", 2), (">I", 4), (">Q", 8), (">b", 1), (">h", 2), (">i", 4), (">q", 8))[c - 0xCC]
            return self.unpack(fmt, n)
        if 0xD4 <= c <= 0xD8:
            return self.ext(1 << (c - 0xD4))
        if c in (0xD9, 0xDA, 0xDB):
            return str(self.take(self.unpack(*((">B", 1), (">H", 2), (">I", 4))[c - 0xD9])), "utf-8")
        if c in (0xDC, 0xDD):
            n = self.unpack(*((">H", 2), (">I", 4))[c - 0xDC])
            return [self.value() for _ in range(n)]
        if c in (0xDE, 0xDF):
            return self.map(self.unpack(*((">H", 2), (">I", 4))[c - 0xDE]))
        raise ValueError(f"msgpack byte 0x{c:02x} at {self.pos - 1} is not a value")

    def map(self, n: int) -> dict:
        out = {}
        for _ in range(n):
            k = self.value()
            out[k] = self.value()
        return out

    def ext(self, n: int):
        code = self.unpack(">b", 1)
        data = self.take(n)
        if code not in (_EXT_NDARRAY, _EXT_NPSCALAR):
            raise ValueError(f"msgpack ext type {code} is not one flax writes for arrays")
        shape, name, raw = _Reader(data).value()
        t = _tensor_from(raw, name, shape)
        if code == _EXT_NPSCALAR and name != "bfloat16":
            return t.numpy()[()]
        return t


def _tensor_from(raw: memoryview, name: str, shape) -> torch.Tensor:
    if name not in _TORCH_DTYPES:
        raise ValueError(f"array dtype {name!r} has no torch counterpart")
    dtype = _TORCH_DTYPES[name]
    if len(raw) == 0:
        return torch.empty(tuple(shape), dtype=dtype)
    # frombuffer shares the input's memory and may sit at any byte offset: clone it
    return torch.frombuffer(raw, dtype=dtype).reshape(tuple(shape)).clone()


def _unchunk(tree: Any) -> Any:
    """Chunked leaves back into arrays, in the dicts where flax puts them."""
    if isinstance(tree, dict):
        if tree.get(CHUNKED_KEY) is True:
            shape = [tree["shape"][str(i)] for i in range(len(tree["shape"]))]
            chunks = [tree["chunks"][str(i)] for i in range(len(tree["chunks"]))]
            return torch.cat([c.reshape(-1) for c in chunks]).reshape(shape)
        return {k: _unchunk(v) for k, v in tree.items()}
    return tree


def restore(data) -> Any:
    """The tree in ``data`` (bytes, a bytearray or a memoryview), as
    ``flax.serialization.msgpack_restore`` reads it, with tensors for
    arrays. Raises ``ValueError`` on bytes left over or a short read."""
    reader = _Reader(bytearray(data) if isinstance(data, bytes) else data)
    tree = reader.value()
    if reader.pos != len(reader.buf):
        raise ValueError(f"{len(reader.buf) - reader.pos} bytes after the msgpack value")
    return _unchunk(tree)
