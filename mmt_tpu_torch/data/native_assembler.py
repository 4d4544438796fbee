"""ctypes binding for native/assembler.cc: batch feature assembly.

The port's copy of mmt_tpu/data/native_assembler.py.  The library is the
port's own copy of the source, ``mmt_tpu_torch/native/assembler.cc``,
compiled at first use by ``_build.build_host`` (``$CXX``, default g++)
into ``build/mmt_tpu_torch/``.

On the native path (the default) the loader's per-sample feature blocks
become lightweight *descriptors* (``FeatSlot`` / ``RowSlot`` tuples
pointing at cached record arrays) and one C call per (batch, expert)
gathers, casts, and pads rows straight into the preallocated batch
arrays, with the GIL released for the call.  This removes the two
biggest cache-hot loader costs (sample.py's choose_or_pad_features block
materialization and collate's 5x7 np.concatenate passes).

Bit-exactness vs the Python path is pinned by
tests/test_torch_native_assembler.py; numpy RNG draws (training row
picks) stay in Python at the same stream position, so batches are the
same on either path (and lockstep determinism across processes holds as
long as every process agrees on the path).

``MMT_TPU_NATIVE_ASSEMBLY``: unset or ``1`` (``on``, ``true``) takes the
native path, ``0`` (``off``, ``false``) the Python path; another value
raises.  There is no silent fallback: if the library cannot be built or
loaded, ``enabled()`` raises.
"""

from __future__ import annotations

import ctypes
from typing import List, NamedTuple, Optional

import numpy as np

from mmt_tpu_torch import _build


class FeatSlot(NamedTuple):
  """One output [T, D] block of the features/features_t/features_ind
  batch tensors. kind: 0 missing, 1 preformed float32 block, 2 raw."""
  kind: int
  k: int                               # raw: rows to copy
  feat: Optional[np.ndarray]           # raw src [n, D] f32/f64 | block [T, D] f32
  t: Optional[np.ndarray]              # raw src [n] f64 | block [T] f32
  ind: Optional[np.ndarray]            # preformed block [T] f32
  pick: Optional[np.ndarray]           # raw: int64 row indices (or None)
  t_start: float
  t_window: float


class RowSlot(NamedTuple):
  """One output [D] row of the avg/max-pool batch tensors.
  kind: 0 zero row (missing), 2 copy/cast ``row``."""
  kind: int
  row: Optional[np.ndarray]            # [D] or [1, D], f32/f64, contiguous


_lib = None
_enabled: Optional[bool] = None


def _load():
  global _lib
  if _lib is not None:
    return _lib
  lib = ctypes.CDLL(str(_build.build_host("assembler.cc")))
  # Every pointer argument is declared void* so plain ints
  # (ndarray.ctypes.data) pass through without per-call ctypes wrappers
  # — this is a loader hot path (one call per batch per expert).
  vp = ctypes.c_void_p
  i64 = ctypes.c_int64
  lib.mmt_asm_features.restype = None
  lib.mmt_asm_features.argtypes = [vp, vp, vp, i64, i64, i64,
                                   vp, vp, vp, vp, vp, vp, vp, vp, vp]
  lib.mmt_asm_rows.restype = None
  lib.mmt_asm_rows.argtypes = [vp, i64, i64, vp, vp, vp]
  _lib = lib
  return lib


def enabled() -> bool:
  """True when descriptor-based native assembly is active: unless
  MMT_TPU_NATIVE_ASSEMBLY selects the Python path, this builds and loads
  the library, and raises if that fails."""
  global _enabled
  if _enabled is None:
    native = _build.env_switch("MMT_TPU_NATIVE_ASSEMBLY", True)
    if native:
      _load()
    _enabled = native
  return _enabled


def set_enabled(value: Optional[bool]) -> None:
  """Force the path (tests, the loader bench); None restores the
  environment's choice."""
  global _enabled
  if value:
    _load()   # fail loudly now, not inside a worker thread
  _enabled = value


def assemble_features(slots: List[FeatSlot], T: int, dim: int):
  """All slots of one expert -> (features [N,T,D], t [N,T], ind [N,T])."""
  lib = _load()
  n = len(slots)
  kind, k, flags = [], [], []
  feat_p, t_p, ind_p, pick_p, t0, tw = [], [], [], [], [], []
  for s in slots:
    kind.append(s.kind)
    if s.kind == 1:
      if s.feat.shape != (T, dim):
        raise ValueError(f"preformed block {s.feat.shape} != ({T}, {dim})")
      k.append(0)
      flags.append(0)
      feat_p.append(s.feat.ctypes.data)
      t_p.append(s.t.ctypes.data)
      ind_p.append(s.ind.ctypes.data)
      pick_p.append(0)
      t0.append(0.0)
      tw.append(1.0)
    elif s.kind == 2:
      if s.k > T or s.feat.shape[1] != dim:
        raise ValueError(
            f"raw slot k={s.k} dim={s.feat.shape[1]} vs T={T} D={dim}")
      k.append(s.k)
      pick = s.pick
      flags.append((1 if s.feat.dtype == np.float64 else 0)
                   | (2 if pick is not None else 0))
      feat_p.append(s.feat.ctypes.data)
      t_p.append(s.t.ctypes.data)
      ind_p.append(0)
      pick_p.append(pick.ctypes.data if pick is not None else 0)
      t0.append(s.t_start)
      tw.append(s.t_window)
    else:
      k.append(0)
      flags.append(0)
      feat_p.append(0)
      t_p.append(0)
      ind_p.append(0)
      pick_p.append(0)
      t0.append(0.0)
      tw.append(1.0)
  feats = np.empty((n, T, dim), np.float32)
  ts = np.empty((n, T), np.float32)
  inds = np.empty((n, T), np.float32)
  kind_a = np.array(kind, np.int32)
  k_a = np.array(k, np.int32)
  flags_a = np.array(flags, np.int32)
  feat_a = np.array(feat_p, np.uint64)
  t_a = np.array(t_p, np.uint64)
  ind_a = np.array(ind_p, np.uint64)
  pick_a = np.array(pick_p, np.uint64)
  t0_a = np.array(t0, np.float64)
  tw_a = np.array(tw, np.float64)
  lib.mmt_asm_features(
      feats.ctypes.data, ts.ctypes.data, inds.ctypes.data, n, T, dim,
      kind_a.ctypes.data, k_a.ctypes.data, flags_a.ctypes.data,
      feat_a.ctypes.data, t_a.ctypes.data, ind_a.ctypes.data,
      pick_a.ctypes.data, t0_a.ctypes.data, tw_a.ctypes.data)
  return feats, ts, inds


def assemble_rows(slots: List[RowSlot], dim: int) -> np.ndarray:
  """All avg (or max) pool slots of one expert -> [N, D] float32."""
  lib = _load()
  n = len(slots)
  kind, f64flag, src = [], [], []
  for s in slots:
    kind.append(s.kind)
    if s.kind != 0:
      f64flag.append(1 if s.row.dtype == np.float64 else 0)
      src.append(s.row.ctypes.data)
    else:
      f64flag.append(0)
      src.append(0)
  out = np.empty((n, dim), np.float32)
  kind_a = np.array(kind, np.int32)
  f64_a = np.array(f64flag, np.int32)
  src_a = np.array(src, np.uint64)
  lib.mmt_asm_rows(out.ctypes.data, n, dim, kind_a.ctypes.data,
                   f64_a.ctypes.data, src_a.ctypes.data)
  return out


def raw_slot_ok(feat: np.ndarray, t: np.ndarray) -> bool:
  """A raw descriptor needs C-contiguous sources of the dtypes the
  kernel handles; anything else falls back to the Python block build."""
  return (feat.flags.c_contiguous and t.flags.c_contiguous
          and feat.dtype in (np.float32, np.float64)
          and t.dtype == np.float64)
