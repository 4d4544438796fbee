"""Dropout from explicit generators.

Port of the dropout sites of mmt_tpu/models/bert.py:116-140 and
mmt_tpu/ops/attention.py:73-76.  The port draws every mask from a
``torch.Generator`` that the caller passes in (never from torch's global
RNG, which ``F.dropout`` and ``nn.Dropout`` use), so one seed fixes one
train step.  The streams differ from jax.random's: tests compare the two
packages with the masks passed in, or with every rate 0.
"""

from __future__ import annotations

import torch


def _parts(part):
  """``part`` as a tuple of (dim, start, full) triples: None, one triple,
  or several (a data-parallel rank's rows and a tensor-parallel rank's
  heads at once)."""
  if not part:
    return ()
  if isinstance(part[0], int):
    return (part,)
  return tuple(part)


def _keep(shape, p, generator, device, part=None):
  """rand >= p at ``shape``; with ``part``, one or more ``(dim, start,
  full)``, drawn at ``full`` entries along each such ``dim`` and sliced
  to [start, start + shape[dim]) there."""
  if generator is None:
    raise ValueError("dropout needs an explicit torch.Generator")
  parts = _parts(part)
  whole = list(shape)
  for dim, _, full in parts:
    whole[dim] = full
  keep = torch.rand(whole, generator=generator, device=device) >= p
  for dim, start, _ in parts:
    keep = keep.narrow(dim, start, shape[dim])
  return keep


def dropout_mask(shape, p, generator, device, *, part=None):
  """Pre-scaled fp32 mask: keep = rand >= p, kept entries 1/(1-p), the
  rest 0.  All ones at p = 0 (no draw).  ``part`` as in ``dropout``."""
  if p == 0.0:
    return torch.ones(shape, dtype=torch.float32, device=device)
  keep = _keep(shape, p, generator, device, part)
  return keep.float() / (1.0 - p)


def dropout(x, p, generator, *, part=None):
  """flax ``nn.Dropout`` semantics: where(keep, x / (1-p), 0) in x's
  dtype; x itself at p = 0 (no draw).

  ``part=(dim, start, full)``: x is the slice [start, start +
  x.shape[dim]) along ``dim`` of a tensor with ``full`` entries there (a
  tensor-parallel rank's attention heads, along dim 1; a data-parallel
  rank's rows of the global batch, along dim 0); a tuple of such triples
  slices each of their dims (both at once under data x tensor
  parallelism).  The mask is drawn at the whole tensor's shape, as for
  the whole tensor, and sliced: every rank consumes the generator alike
  and keeps what one device would."""
  if p == 0.0:
    return x
  keep = _keep(x.shape, p, generator, x.device, part)
  return torch.where(keep, x / (1.0 - p), torch.zeros_like(x))
