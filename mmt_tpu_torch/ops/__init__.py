"""Ops of the port: the fused FFN block and MoE similarity (each a CUDA
kernel with its plain PyTorch version beside it), attention and ranking.

Dispatch rule of every kernel wrapper: a CPU tensor takes the plain
version; a CUDA tensor launches the kernel or raises.  The kernels fall
into four families: ``"ffn"`` (the FFN blocks B1, B2, B3, B6, B7),
``"similarity"`` (B4), ``"ranks"`` (B5) and ``"moe"`` (the grouped expert
GEMMs of ``ops/moe.py``).  ``plain_versions()`` runs a
family's plain versions on the card instead, when a user asks for it: to
compare a whole run against them, or, through ``environment_switches``,
by the JAX package's variables (mmt_tpu/ops/__init__.py:
enable_tpu_default_kernels).  A switch never falls back: a family left on
its kernels still raises when its kernel fails to build or launch.
"""

from __future__ import annotations

import contextlib
import logging
import os

logger = logging.getLogger(__name__)

FAMILIES = ("ffn", "similarity", "ranks", "moe")
# The families a user may send to their plain versions by the environment,
# under the JAX package's names ("0", or any value but "1", as there).  The
# fused ranks have no switch, as in the JAX package.
SWITCHES = {"ffn": "MMT_TPU_PALLAS_FFN",
            "similarity": "MMT_TPU_PALLAS_SIMILARITY"}

_plain = frozenset()


@contextlib.contextmanager
def plain_versions(*families):
  """Within the block, CUDA tensors of ``families`` (every family when
  none is named) go through the plain versions."""
  global _plain
  unknown = sorted(set(families) - set(FAMILIES))
  if unknown:
    raise ValueError(f"unknown kernel families {unknown}: expected some of "
                     f"{FAMILIES}")
  prev = _plain
  _plain = prev | frozenset(families or FAMILIES)
  try:
    yield
  finally:
    _plain = prev


def use_kernel(x, family: str) -> bool:
  """True if ``x`` lies on the card and ``family``'s plain versions are
  not forced."""
  return x.is_cuda and family not in _plain


def kernel_families(device) -> dict:
  """{family: whether its kernel runs} for tensors on ``device`` as the
  families are forced now."""
  on_card = str(device).startswith("cuda")
  return {f: on_card and f not in _plain for f in FAMILIES}


def switched_families(environ=os.environ) -> tuple:
  """The families the environment sends to their plain versions: those
  whose SWITCHES variable is set to anything but "1"."""
  return tuple(f for f, name in SWITCHES.items()
               if environ.get(name, "1") != "1")


@contextlib.contextmanager
def environment_switches(environ=os.environ):
  """Within the block, the families ``switched_families`` names run their
  plain versions (the entry points' counterpart of the JAX package's
  enable_tpu_default_kernels); the others keep their kernels."""
  families = switched_families(environ)
  if not families:
    yield families
    return
  logger.info("kernel switches: %s on the plain versions (%s)",
              ", ".join(families),
              ", ".join(f"{SWITCHES[f]}={environ[SWITCHES[f]]}"
                        for f in families))
  with plain_versions(*families):
    yield families
