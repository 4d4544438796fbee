"""Reader of the JAX package's ``.msgpack`` files, in pure Python.

The JAX package writes its checkpoints, converted text-tower inits and
serving indices with ``flax.serialization`` (``to_bytes`` /
``msgpack_serialize``); ``msgpack_restore`` here returns what flax's own
``msgpack_restore`` returns for them, without the ``msgpack`` package:

* msgpack maps, arrays (as lists), str, bin, nil, bool, every int width
  and float 32 / 64;
* ext 1, an ndarray: an inner msgpack ``(shape, dtype name, C-order
  bytes)``, the dtype name read as bytes, as flax reads it;
* ext 2, a complex ``(real, imag)``; ext 3, a numpy scalar (``arr[()]``);
* the ``__msgpack_chunked_array__`` dicts flax writes for leaves over
  2^30 bytes, assembled into one array allocated once;
* dtype ``bfloat16``, returned as a ``torch.bfloat16`` tensor with the
  same bits (numpy has no bfloat16).

Arrays come back as read-only numpy views of the bytes read where the
offset is aligned to the dtype, else as copies; chunked ones are
assembled into new arrays, bfloat16 ones into new tensors.
"""

from __future__ import annotations

import os
import struct

import numpy as np
import torch

CHUNKED = "__msgpack_chunked_array__"

# Fixed-width msgpack scalars: type byte -> (struct format, byte count).
_SCALARS = {
    0xca: (">f", 4), 0xcb: (">d", 8),
    0xcc: (">B", 1), 0xcd: (">H", 2), 0xce: (">I", 4), 0xcf: (">Q", 8),
    0xd0: (">b", 1), 0xd1: (">h", 2), 0xd2: (">i", 4), 0xd3: (">q", 8),
}
# Length-prefixed types: type byte -> (kind, struct format of the length).
_SIZED = {
    0xc4: ("bin", ">B"), 0xc5: ("bin", ">H"), 0xc6: ("bin", ">I"),
    0xc7: ("ext", ">B"), 0xc8: ("ext", ">H"), 0xc9: ("ext", ">I"),
    0xd9: ("str", ">B"), 0xda: ("str", ">H"), 0xdb: ("str", ">I"),
    0xdc: ("array", ">H"), 0xdd: ("array", ">I"),
    0xde: ("map", ">H"), 0xdf: ("map", ">I"),
}
_FIXEXT = {0xd4: 1, 0xd5: 2, 0xd6: 4, 0xd7: 8, 0xd8: 16}


class _Unpacker:
  """One msgpack document in ``buf`` (a byte memoryview).  ``raw`` keeps
  str payloads as bytes, as msgpack's ``raw=True`` does, and bin payloads
  as views of ``buf`` (the inner document of an ndarray); otherwise bin
  comes back as bytes."""

  def __init__(self, buf: memoryview, raw: bool = False):
    self.buf, self.raw, self.pos = buf, raw, 0

  def _take(self, n):
    start, self.pos = self.pos, self.pos + n
    if self.pos > len(self.buf):
      raise ValueError("msgpack data ends inside an object")
    return self.buf[start:self.pos]

  def _int(self, fmt, n):
    return struct.unpack(fmt, self._take(n))[0]

  def _str(self, n):
    data = self._take(n)
    return bytes(data) if self.raw else str(data, "utf-8")

  def _array(self, n):
    return [self.unpack() for _ in range(n)]

  def _map(self, n):
    out = {}
    for _ in range(n):
      key = self.unpack()
      out[key] = self.unpack()
    return out

  def unpack(self):
    b = self._take(1)[0]
    if b <= 0x7f:
      return b
    if b >= 0xe0:
      return b - 0x100
    if b <= 0x8f:
      return self._map(b & 0x0f)
    if b <= 0x9f:
      return self._array(b & 0x0f)
    if b <= 0xbf:
      return self._str(b & 0x1f)
    if b in (0xc0, 0xc2, 0xc3):
      return {0xc0: None, 0xc2: False, 0xc3: True}[b]
    if b in _SCALARS:
      return self._int(*_SCALARS[b])
    if b in _FIXEXT:
      code = self._int(">b", 1)
      return _ext(code, self._take(_FIXEXT[b]))
    if b not in _SIZED:
      raise ValueError(f"msgpack type byte 0x{b:02x} is not valid")
    kind, fmt = _SIZED[b]
    n = self._int(fmt, struct.calcsize(fmt))
    if kind == "bin":
      data = self._take(n)
      return data if self.raw else bytes(data)
    if kind == "ext":
      code = self._int(">b", 1)
      return _ext(code, self._take(n))
    return getattr(self, f"_{kind}")(n)


def _unpack_all(buf: memoryview, raw: bool = False):
  reader = _Unpacker(buf, raw)
  obj = reader.unpack()
  if reader.pos != len(buf):
    raise ValueError(f"{len(buf) - reader.pos} bytes of extra data after "
                     "the msgpack document")
  return obj


def _ndarray(data: memoryview):
  """flax's ``_ndarray_from_bytes``: (shape, dtype name, C-order bytes)."""
  shape, name, payload = _unpack_all(data, raw=True)
  shape = tuple(shape)
  if name == b"bfloat16":
    if not len(payload):
      return torch.empty(shape, dtype=torch.bfloat16)
    return torch.frombuffer(bytearray(payload),
                            dtype=torch.bfloat16).reshape(shape)
  arr = np.frombuffer(payload, dtype=np.dtype(name.decode())).reshape(shape)
  # A view at an offset the dtype's size does not divide is copied, so
  # that every array is aligned, as flax's (each in bytes of its own) are.
  return arr if arr.flags.aligned else arr.copy()


def _ext(code: int, data: memoryview):
  if code == 1:
    return _ndarray(data)
  if code == 2:
    real, imag = _unpack_all(data)
    return complex(real, imag)
  if code == 3:
    return _ndarray(data)[()]
  raise ValueError(f"msgpack ext type {code} is not one flax writes")


def _unchunk(data):
  """One array from flax's ``_chunk`` dict, filled chunk by chunk into an
  array allocated once."""
  shape = tuple(data["shape"][str(i)] for i in range(len(data["shape"])))
  chunks = [data["chunks"][str(i)] for i in range(len(data["chunks"]))]
  total = sum(len(c) for c in chunks)
  if isinstance(chunks[0], torch.Tensor):
    out = torch.empty(total, dtype=chunks[0].dtype)
  else:
    out = np.empty(total, dtype=np.result_type(*chunks))
  at = 0
  for chunk in chunks:
    out[at:at + len(chunk)] = chunk
    at += len(chunk)
  return out.reshape(shape)


def _unchunk_leaves(tree):
  """flax's ``_unchunk_array_leaves_in_place``: dicts only, not lists."""
  if not isinstance(tree, dict):
    return tree
  if CHUNKED in tree:
    return _unchunk(tree)
  for key, val in tree.items():
    if isinstance(val, dict):
      tree[key] = _unchunk_leaves(val)
  return tree


def msgpack_restore(source):
  """A flax msgpack document -> nested dicts / lists of Python values,
  numpy arrays and (bfloat16) torch tensors, as
  ``flax.serialization.msgpack_restore`` returns it.  ``source`` is the
  encoded bytes or a path, read once."""
  if isinstance(source, (str, os.PathLike)):
    with open(source, "rb") as f:
      source = f.read()
  return _unchunk_leaves(_unpack_all(memoryview(source).cast("B")))
