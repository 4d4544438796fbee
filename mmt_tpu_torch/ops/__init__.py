"""Ops of the port: the fused FFN block and MoE similarity (each a CUDA
kernel with its plain PyTorch version beside it), attention and ranking.

Dispatch rule of every kernel wrapper: a CPU tensor takes the plain
version; a CUDA tensor launches the kernel or raises.  ``plain_versions()``
runs the plain versions on the card instead, for comparing a whole run
against them.
"""

from __future__ import annotations

import contextlib

_force_plain = False


@contextlib.contextmanager
def plain_versions():
  """Within the block, CUDA tensors go through the plain versions."""
  global _force_plain
  prev, _force_plain = _force_plain, True
  try:
    yield
  finally:
    _force_plain = prev


def use_kernel(x) -> bool:
  """True if ``x`` lies on the card and the plain versions are not forced."""
  return x.is_cuda and not _force_plain
