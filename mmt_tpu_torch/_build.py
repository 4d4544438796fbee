"""Build the port's native code and load it through ctypes.

Two builders, both at first use into ``build/mmt_tpu_torch/`` beside the
package, each library named by a hash of its sources and flags, so an
edited source rebuilds and an unchanged one loads the cached build:

- ``build``: the CUDA kernels under ``csrc/`` compile, one nvcc process
  each and all at once, into one shared library with a plain C interface
  (no PyTorch headers, so the build takes seconds).
- ``build_host``: a host library from one C++ source under ``native/``
  (the batch assembler and the WordPiece tokenizer), compiled by ``$CXX``
  (default ``g++``) with ``HOST_FLAGS``.  It needs no nvcc and no card.

There is no fallback: without ``nvcc`` or a card ``load_library`` raises,
and without a working C++ compiler ``build_host`` raises.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import shutil
import subprocess
import tempfile

CSRC = pathlib.Path(__file__).resolve().parent / "csrc"
SOURCES = ("ffn_block.cu", "ffn_train_bwd.cu", "moe_similarity.cu",
           "fused_ranks.cu")
HEADERS = ("ffn_common.cuh", "ffn_gemm.cuh", "sim_tile.cuh")
NATIVE = CSRC.parent / "native"
BUILD_DIR = CSRC.parent.parent / "build" / "mmt_tpu_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

HOST_FLAGS = ("-O3", "-fPIC", "-std=c++17", "-shared")

_P = ctypes.c_void_p
_I = ctypes.c_int
_SIGNATURES = {
    # x, w1, b1, w2, b2, gamma, beta, out, xb, g, R, H, I, eps,
    # compute_dtype, tile, stream
    "mmt_ffn_block": [_P] * 10 + [_I, _I, _I, ctypes.c_float, _I, _I, _P],
    # x, drop, w1, b1, w2, b2, gamma, beta, out, inter, z, xb, g, R, H, I,
    # eps, compute_dtype, tile, stream
    "mmt_ffn_train_fwd": [_P] * 13 + [_I, _I, _I, ctypes.c_float, _I, _I,
                                      _P],
    # x, w1, b1, w2, out, xb, g, R, H, I, compute_dtype, tile, stream
    "mmt_ffn_partial": [_P] * 7 + [_I] * 5 + [_P],
    # x, w1, b1, w2, out, inter, xb, g, R, H, I, compute_dtype, tile, stream
    "mmt_ffn_train_fwd_partial": [_P] * 8 + [_I] * 5 + [_P],
    # dy, z, inter, drop, w1, w2, gamma, dx, dz, dinter, dffn, w1t, w2t,
    # R, H, I, eps, compute_dtype, add_dz, tile, stream
    "mmt_ffn_train_bwd": [_P] * 13 + [_I, _I, _I, ctypes.c_float, _I, _I,
                                      _I, _P],
    # t, v, tw, vw, out, tt, vt, Q, V, K, M, ldt, ldv, tile, stream
    "mmt_moe_similarity": [_P] * 7 + [_I] * 7 + [_P],
    # t, c, tw, cw, gt, gtcol, colbias, closer, tied, tt, ct, Q, C, K, M,
    # ldt, ldc, tile, stream
    "mmt_fused_ranks": [_P] * 11 + [_I] * 7 + [_P],
}

_lib = None


def find_nvcc() -> str:
  """Path of nvcc: on PATH, else under $CUDA_HOME (default /usr/local/cuda)."""
  nvcc = shutil.which("nvcc")
  if nvcc:
    return nvcc
  cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
  nvcc = os.path.join(cuda_home, "bin", "nvcc")
  if os.path.isfile(nvcc) and os.access(nvcc, os.X_OK):
    return nvcc
  raise RuntimeError(
      "nvcc not found (searched PATH and $CUDA_HOME/bin): the CUDA kernels "
      "of mmt_tpu_torch are built on a machine with the CUDA toolkit")


def _source_hash() -> str:
  h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
  for name in SOURCES + HEADERS:
    h.update(name.encode())
    h.update((CSRC / name).read_bytes())
  return h.hexdigest()[:16]


def build() -> pathlib.Path:
  """Compile the sources into the cached library (if not built yet).

  Each source compiles in its own nvcc process, all started together;
  then one nvcc links the objects.  Returns the library's path.  The
  compilers' output (including ptxas's register and shared-memory report)
  is kept beside it as ``build.log``.
  """
  target = BUILD_DIR / f"libmmt_kernels_{_source_hash()}.so"
  if target.exists():
    return target
  nvcc = find_nvcc()
  BUILD_DIR.mkdir(parents=True, exist_ok=True)
  with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
    objs = [os.path.join(tmp, s.replace(".cu", ".o")) for s in SOURCES]
    cmds = [[nvcc, *NVCC_FLAGS, "-c", "-o", o, str(CSRC / s)]
            for s, o in zip(SOURCES, objs)]
    procs = [subprocess.Popen(c, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for c in cmds]
    outs = [p.communicate()[0] for p in procs]
    lib = os.path.join(tmp, "lib.so")
    link = [nvcc, "-shared", "-o", lib, *objs]
    log = [" ".join(c) + "\n" + out for c, out in zip(cmds, outs)]
    failed = [(c, p.returncode) for c, p in zip(cmds, procs) if p.returncode]
    if not failed:
      proc = subprocess.run(link, capture_output=True, text=True)
      log.append(" ".join(link) + "\n" + proc.stdout + proc.stderr)
      if proc.returncode:
        failed.append((link, proc.returncode))
    (BUILD_DIR / "build.log").write_text("".join(log))
    if failed:
      raise RuntimeError(f"nvcc failed ({failed[0][1]}):\n" + "".join(log))
    os.replace(lib, target)
  return target


def env_switch(name: str, default: bool) -> bool:
  """The environment switch ``name``: 1 / on / true, 0 / off / false, or
  ``default`` when unset or empty; any other value raises."""
  value = os.environ.get(name, "").strip().lower()
  if not value:
    return default
  if value in ("1", "on", "true"):
    return True
  if value in ("0", "off", "false"):
    return False
  raise ValueError(f"{name}={value!r}: use 1 or 0")


def build_host(source: str) -> pathlib.Path:
  """Compile ``native/<source>`` into a shared library (if not built yet)
  and return its path.  The name hashes the compiler, the flags and the
  source.  A missing compiler or a failed compile raises, naming the
  command and its output."""
  cxx = os.environ.get("CXX") or "g++"
  src = NATIVE / source
  h = hashlib.sha256(" ".join((cxx,) + HOST_FLAGS).encode())
  h.update(src.read_bytes())
  target = BUILD_DIR / f"lib{src.stem}_{h.hexdigest()[:16]}.so"
  if target.exists():
    return target
  BUILD_DIR.mkdir(parents=True, exist_ok=True)
  with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
    lib = os.path.join(tmp, "lib.so")
    cmd = [cxx, *HOST_FLAGS, "-o", lib, str(src)]
    try:
      proc = subprocess.run(cmd, capture_output=True, text=True)
    except OSError as e:
      raise RuntimeError(f"{' '.join(cmd)}: cannot run the C++ compiler "
                         f"({e}); set CXX to one") from e
    if proc.returncode:
      raise RuntimeError(f"{' '.join(cmd)} failed ({proc.returncode}):\n"
                         + proc.stdout + proc.stderr)
    os.replace(lib, target)
  return target


def load_library() -> ctypes.CDLL:
  """The kernels' library, built and loaded once per process."""
  global _lib
  if _lib is None:
    lib = ctypes.CDLL(str(build()))
    for name, argtypes in _SIGNATURES.items():
      fn = getattr(lib, name)
      fn.argtypes = argtypes
      fn.restype = ctypes.c_int
    lib.mmt_error_string.argtypes = [ctypes.c_int]
    lib.mmt_error_string.restype = ctypes.c_char_p
    _lib = lib
  return _lib


def check(lib: ctypes.CDLL, name: str, code: int) -> None:
  """Raise if a C entry point returned a CUDA error code."""
  if code != 0:
    msg = lib.mmt_error_string(code).decode()
    raise RuntimeError(f"{name}: CUDA error {code} ({msg})")
