"""Normalisations and the batched per-modality heads.

Port of mmt_tpu/models/components.py:24-46 and :314-416.  The per-modality
modules are parameter holders under the reference's names
(``text_GU.{mod}.fc``, ``text_GU.{mod}.cg.fc``,
``text_GU.{mod}.cg.batch_norm``, ``video_dim_reduce.{mod}.fc``); the
forward runs all modalities at once over stacked weights.  Heads run in
fp32, as in the JAX package.
"""

from __future__ import annotations

import torch
from torch import nn

BN_EPS = 1e-5
BN_MOMENTUM = 0.9   # flax convention: running = 0.9 * running + 0.1 * batch


def l2_normalize(x, dim=-1, eps=1e-12):
  """F.normalize(p=2) semantics: x / max(||x||, eps)."""
  sq = (x * x).sum(dim, keepdim=True)
  return x / torch.sqrt(sq.clamp_min(eps * eps))


def l1_normalize(x, dim=-1, eps=1e-12):
  """F.normalize(p=1) semantics."""
  return x / x.abs().sum(dim, keepdim=True).clamp_min(eps)


class ContextGating(nn.Module):
  """Holder: ``fc`` and ``batch_norm`` (x * sigmoid(BN(fc(x))))."""

  def __init__(self, dim, *, device=None):
    super().__init__()
    self.fc = nn.Linear(dim, dim, device=device)
    self.batch_norm = nn.BatchNorm1d(dim, eps=BN_EPS, device=device)


class GatedEmbeddingUnit(nn.Module):
  """Holder: ``fc`` then ``cg`` (a ContextGating)."""

  def __init__(self, in_dim, out_dim, *, device=None):
    super().__init__()
    self.fc = nn.Linear(in_dim, out_dim, device=device)
    self.cg = ContextGating(out_dim, device=device)


class ReduceDim(nn.Module):
  """Holder: ``fc`` (Linear, then L2 norm)."""

  def __init__(self, in_dim, out_dim, *, device=None):
    super().__init__()
    self.fc = nn.Linear(in_dim, out_dim, device=device)


def init_heads_(module: nn.Module, generator: torch.Generator):
  """Linear weights ~ N(0, 1/fan_in), zero biases (BatchNorm keeps its
  construction defaults: identity affine, zero mean, unit variance)."""
  with torch.no_grad():
    for mod in module.modules():
      if isinstance(mod, nn.Linear):
        mod.weight.normal_(0.0, mod.in_features ** -0.5, generator=generator)
        mod.bias.zero_()


def batched_gated_embedding(x, geus, *, train=False):
  """All modalities' GatedEmbeddingUnits, followed by the L2 norm.
  x [B, D_in] -> [B, M, D_out].

  Eval mode normalises the gate with the BatchNorm running statistics.
  Train mode (mmt_tpu/models/components.py:_batched_torch_bn) uses the
  batch moments, with the fast biased variance mean(g^2) - mean^2, and
  updates the running buffers in place to 0.9 * old + 0.1 * batch: flax's
  BatchNorm, whose running variance is biased (torch's BatchNorm1d keeps
  an unbiased one, so it is not called here).
  """
  w1 = torch.stack([g.fc.weight for g in geus])              # [M, Do, Di]
  b1 = torch.stack([g.fc.bias for g in geus])                # [M, Do]
  wc = torch.stack([g.cg.fc.weight for g in geus])           # [M, Do, Do]
  bc = torch.stack([g.cg.fc.bias for g in geus])
  bns = [g.cg.batch_norm for g in geus]
  h = torch.einsum("bd,med->bme", x, w1) + b1
  gate = torch.einsum("bme,mfe->bmf", h, wc) + bc
  if train:
    mean = gate.mean(0)                                      # [M, Do]
    var = (gate * gate).mean(0) - mean * mean
    with torch.no_grad():
      for i, bn in enumerate(bns):
        for buf, batch in ((bn.running_mean, mean), (bn.running_var, var)):
          buf.copy_(BN_MOMENTUM * buf + (1.0 - BN_MOMENTUM) * batch[i])
        bn.num_batches_tracked += 1
  else:
    mean = torch.stack([bn.running_mean for bn in bns])
    var = torch.stack([bn.running_var for bn in bns])
  scale = torch.stack([bn.weight for bn in bns])
  shift = torch.stack([bn.bias for bn in bns])
  gate = (gate - mean) * torch.rsqrt(var + BN_EPS) * scale + shift
  return l2_normalize(h * torch.sigmoid(gate))


def batched_reduce_dim_ragged(xs, reducers):
  """All modalities' ReduceDims over ragged inputs: each x_i [B, D_i] and
  its weight are zero-padded to max(D_i), so one batched product is exact.
  Returns the L2-normalised [B, M, D_out]."""
  d_max = max(x.shape[-1] for x in xs)
  pad = lambda t: nn.functional.pad(t, (0, d_max - t.shape[-1]))
  xp = torch.stack([pad(x.float()) for x in xs], 1)          # [B, M, Dmax]
  wp = torch.stack([pad(r.fc.weight) for r in reducers])     # [M, Do, Dmax]
  b = torch.stack([r.fc.bias for r in reducers])
  return l2_normalize(torch.einsum("bmd,med->bme", xp, wp) + b)


def batched_moe_logits(x, heads):
  """All modalities' Linear(D -> 1) MoE heads as one [D, M] product."""
  w = torch.cat([h.weight for h in heads], 0)                # [M, D]
  b = torch.cat([h.bias for h in heads], 0)
  return x @ w.T + b
