"""Normalisations, the batched per-modality heads, the collaborative
gating units and the word-embedding text path.

Port of mmt_tpu/models/components.py.  The per-modality heads are
parameter holders under the reference's names (``text_GU.{mod}.fc``,
``text_GU.{mod}.cg.fc``, ``text_GU.{mod}.cg.batch_norm``,
``video_dim_reduce.{mod}.fc``); the forward runs all modalities at once
over stacked weights.  ``ContextGating``, ``GatedEmbeddingUnitReasoning``
(vid_cont coll), ``NetVLAD``, ``LSTMPooler`` and ``TxtEmbeddings`` (the
word-embedding text path) are modules with a forward, and so are the
reference's two units no config uses, ``MimicCEGatedEmbeddingUnit`` and
``GatedLinearUnit``.  Heads run in fp32, as in the JAX
package.

Every BatchNorm here is flax's (mmt_tpu/models/components.py:
TorchBatchNorm): batch moments over all leading rows in train mode, with
the fast biased variance, and running buffers updated to 0.9 * old + 0.1
* batch.  ``nn.BatchNorm1d`` is only the holder of the parameters and
buffers: its own forward (unbiased running variance) is never called.
With a ``dp`` (``parallel.DataParallel``) the train-mode moments are the
global batch's: the sums of x and x^2 over this rank's rows are
all-reduced (``parallel.all_reduce_sum``, differentiable), so every rank
normalises with, and updates its buffers to, the moments one device would
take over the whole batch (mmt_tpu/models/components.py under GSPMD).
"""

from __future__ import annotations

import torch
from torch import nn

from mmt_tpu_torch.parallel import mesh as mesh_lib

BN_EPS = 1e-5
BN_MOMENTUM = 0.9   # flax convention: running = 0.9 * running + 0.1 * batch


def l2_normalize(x, dim=-1, eps=1e-12):
  """F.normalize(p=2) semantics: x / max(||x||, eps)."""
  sq = (x * x).sum(dim, keepdim=True)
  return x / torch.sqrt(sq.clamp_min(eps * eps))


def l1_normalize(x, dim=-1, eps=1e-12):
  """F.normalize(p=1) semantics."""
  return x / x.abs().sum(dim, keepdim=True).clamp_min(eps)


def safe_norm(x, dim=-1, eps=1e-12):
  """||x|| along ``dim``, clamped below by eps (a finite gradient at 0)."""
  return torch.sqrt((x * x).sum(dim).clamp_min(eps * eps))


def _update_running(bn, mean, var):
  """flax's running update: buffer = 0.9 * buffer + 0.1 * batch."""
  with torch.no_grad():
    for buf, batch in ((bn.running_mean, mean), (bn.running_var, var)):
      buf.copy_(BN_MOMENTUM * buf + (1.0 - BN_MOMENTUM) * batch)
    bn.num_batches_tracked += 1


def _moments(x, dp):
  """Mean and mean of squares over dim 0 of x; with ``dp`` over the
  global batch (every rank holds as many rows)."""
  if dp is None or dp.size == 1:
    return x.mean(0), (x * x).mean(0)
  sums = mesh_lib.all_reduce_sum(torch.stack([x.sum(0), (x * x).sum(0)]),
                                 dp)
  n = x.shape[0] * dp.size
  return sums[0] / n, sums[1] / n


def batch_norm(x, bn, *, train, dp=None):
  """flax ``nn.BatchNorm`` (momentum 0.9, eps 1e-5) over x's last dim with
  ``bn``'s parameters; train mode takes the moments over every leading
  row (of the global batch with ``dp``), var = max(0, mean(x^2) -
  mean^2), and updates ``bn``'s buffers."""
  if train:
    mean, sq = _moments(x.reshape(-1, x.shape[-1]), dp)
    var = (sq - mean * mean).clamp_min(0.0)
    _update_running(bn, mean, var)
  else:
    mean, var = bn.running_mean, bn.running_var
  return (x - mean) * (torch.rsqrt(var + BN_EPS) * bn.weight) + bn.bias


class ContextGating(nn.Module):
  """``fc`` and, with ``use_bn``, ``batch_norm``: x * sigmoid(BN(fc(x)))
  (mmt_tpu/models/components.py:ContextGating).  The batched heads read
  its parameters; its own forward serves ``MimicCEGatedEmbeddingUnit``."""

  def __init__(self, dim, *, use_bn=True, device=None):
    super().__init__()
    self.use_bn = use_bn
    self.fc = nn.Linear(dim, dim, device=device)
    if use_bn:
      self.batch_norm = nn.BatchNorm1d(dim, eps=BN_EPS, device=device)

  def forward(self, x, *, train=False, dp=None):
    gate = self.fc(x)
    if self.use_bn:
      gate = batch_norm(gate, self.batch_norm, train=train, dp=dp)
    return x * torch.sigmoid(gate)


class MimicCEGatedEmbeddingUnit(nn.Module):
  """``cg`` (a ContextGating at the input's width: no input projection),
  then the L2 norm (mmt_tpu/models/components.py:
  MimicCEGatedEmbeddingUnit)."""

  def __init__(self, input_dimension, *, use_bn=True, device=None):
    super().__init__()
    self.cg = ContextGating(input_dimension, use_bn=use_bn, device=device)

  def forward(self, x, *, train=False, dp=None):
    return l2_normalize(self.cg(x, train=train, dp=dp))


class GatedLinearUnit(nn.Module):
  """x * sigmoid(mask), the glu of cat(x, mask)
  (mmt_tpu/models/components.py:GatedLinearUnit); no parameters."""

  def forward(self, x, mask):
    return x * torch.sigmoid(mask)


class GatedEmbeddingUnit(nn.Module):
  """Holder: ``fc`` then ``cg`` (a ContextGating; without BatchNorm for
  txt_pro 'gem')."""

  def __init__(self, in_dim, out_dim, *, use_bn=True, device=None):
    super().__init__()
    self.fc = nn.Linear(in_dim, out_dim, device=device)
    self.cg = ContextGating(out_dim, use_bn=use_bn, device=device)


class ContextGatingReasoning(nn.Module):
  """x * sigmoid(BN(mask) + BN2(fc(x))) (mmt_tpu/models/components.py:
  ContextGatingReasoning; ``batch_norm`` gates the mask, ``batch_norm2``
  fc(x))."""

  def __init__(self, dim, *, device=None):
    super().__init__()
    self.fc = nn.Linear(dim, dim, device=device)
    self.batch_norm = nn.BatchNorm1d(dim, eps=BN_EPS, device=device)
    self.batch_norm2 = nn.BatchNorm1d(dim, eps=BN_EPS, device=device)

  def forward(self, x, mask, *, train=False, dp=None):
    gate = (batch_norm(mask, self.batch_norm, train=train, dp=dp)
            + batch_norm(self.fc(x), self.batch_norm2, train=train, dp=dp))
    return x * torch.sigmoid(gate)


class GatedEmbeddingUnitReasoning(nn.Module):
  """``cg`` (a ContextGatingReasoning), then the L2 norm: one modality's
  output unit of the collaborative gating (vid_cont 'coll')."""

  def __init__(self, dim, *, device=None):
    super().__init__()
    self.cg = ContextGatingReasoning(dim, device=device)

  def forward(self, x, mask, *, train=False, dp=None):
    return l2_normalize(self.cg(x, mask, train=train, dp=dp))


class NetVLAD(nn.Module):
  """NetVLAD over x [B, N, D] -> [B, D * K] (mmt_tpu/models/components.py:
  NetVLAD): soft assignment x @ clusters, BatchNorm over all B * N token
  rows (padded ones included, as the JAX package's ``flat`` is), softmax
  over the K clusters, residuals against ``clusters2`` summed per cluster,
  the intra norm over D, then a global L2 norm."""

  def __init__(self, cluster_size, feature_size, *, device=None):
    super().__init__()
    self.cluster_size, self.feature_size = cluster_size, feature_size
    self.clusters = nn.Parameter(
        torch.empty(feature_size, cluster_size, device=device))
    self.clusters2 = nn.Parameter(
        torch.empty(1, feature_size, cluster_size, device=device))
    self.batch_norm = nn.BatchNorm1d(cluster_size, eps=BN_EPS, device=device)

  def init_weights(self, generator):
    """Clusters ~ N(0, 1/sqrt(D)), as the JAX package draws them."""
    with torch.no_grad():
      for p in (self.clusters, self.clusters2):
        p.normal_(0.0, self.feature_size ** -0.5, generator=generator)

  @property
  def out_dim(self):
    return self.cluster_size * self.feature_size

  def forward(self, x, *, train=False, dp=None):
    b, n, d = x.shape
    x = x.float()
    assignment = batch_norm(x.reshape(-1, d) @ self.clusters,
                            self.batch_norm, train=train, dp=dp)
    assignment = torch.softmax(assignment, 1).reshape(b, n, -1)
    a = assignment.sum(1, keepdim=True) * self.clusters2       # [B, D, K]
    vlad = torch.einsum("bnk,bnd->bdk", assignment, x) - a
    vlad = l2_normalize(vlad, dim=1)                            # over D
    return l2_normalize(vlad.reshape(b, -1))


class LSTMPooler(nn.Module):
  """One-direction LSTM over the padded tokens, then ``fc`` of the last
  valid hidden state (mmt_tpu/models/components.py:LSTMPooler).

  torch's LSTM runs over the whole padded sequence: it is causal, so its
  output at step length - 1 is the state the JAX package's
  ``nn.RNN(seq_lengths=)`` carries out.  A row of length 0 (a padded
  caption slot) reads step -1 there (flax's ``_select_last_carry`` takes
  index ``seq_lengths - 1``): the state after all T padded steps, so here
  too (``pack_padded_sequence`` would refuse the row).  Gates i, f, g, o
  as flax's OptimizedLSTMCell (convert.py fuses its per-gate kernels).
  """

  def __init__(self, input_dim, hidden_dim, output_dim, num_layers=1, *,
               device=None):
    super().__init__()
    self.lstm = nn.LSTM(input_dim, hidden_dim, num_layers, batch_first=True,
                        device=device)
    self.fc = nn.Linear(hidden_dim, output_dim, device=device)
    # flax's cell has one bias a gate, the hidden side's (bias_hh): the
    # input side's stays zero and frozen, so a step moves each gate's bias
    # once, as in the JAX package.
    for layer in range(num_layers):
      getattr(self.lstm, f"bias_ih_l{layer}").requires_grad_(False)

  def init_weights(self, generator):
    """Every weight ~ N(0, 1/fan_in), zero biases."""
    with torch.no_grad():
      for name, p in self.named_parameters():
        if name.endswith("bias"):
          p.zero_()
        else:
          p.normal_(0.0, p.shape[1] ** -0.5, generator=generator)

  def forward(self, x, lengths):
    out, _ = self.lstm(x.float())
    step = (lengths.long() - 1) % x.shape[1]            # length 0: step T-1
    return self.fc(out[torch.arange(x.shape[0], device=x.device), step])


class TxtEmbeddings(nn.Module):
  """``word_embeddings``, a word-vector table whose row 0 ([PAD]) reads
  as zero in the forward whatever the table holds (padding_idx 0 of the
  reference; the JAX package's ``table.at[0].set(0.0)``)."""

  def __init__(self, vocab_size, emb_dim, *, device=None):
    super().__init__()
    self.word_embeddings = nn.Embedding(vocab_size, emb_dim, device=device)

  def forward(self, input_ids):
    emb = self.word_embeddings.weight[input_ids]
    return torch.where((input_ids == 0)[..., None], torch.zeros_like(emb),
                       emb)


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


def batched_gated_embedding(x, geus, *, train=False, use_bn=True,
                            normalize=True, dp=None):
  """All modalities' GatedEmbeddingUnits, followed by the L2 norm (unless
  ``normalize`` is off).  x [B, D_in] -> [B, M, D_out].

  Without ``use_bn`` (txt_pro 'gem') the gate is sigmoid(fc(h)).  Eval
  mode normalises the gate with the BatchNorm running statistics.
  Train mode (mmt_tpu/models/components.py:_batched_torch_bn) uses the
  batch moments, with the fast biased variance mean(g^2) - mean^2, and
  updates the running buffers in place to 0.9 * old + 0.1 * batch: flax's
  BatchNorm, whose running variance is biased (torch's BatchNorm1d keeps
  an unbiased one, so it is not called here).  ``dp``: the moments of
  the global batch.
  """
  w1 = torch.stack([g.fc.weight for g in geus])              # [M, Do, Di]
  b1 = torch.stack([g.fc.bias for g in geus])                # [M, Do]
  wc = torch.stack([g.cg.fc.weight for g in geus])           # [M, Do, Do]
  bc = torch.stack([g.cg.fc.bias for g in geus])
  h = torch.einsum("bd,med->bme", x, w1) + b1
  gate = torch.einsum("bme,mfe->bmf", h, wc) + bc
  if use_bn:
    gate = _batched_bn(gate, [g.cg.batch_norm for g in geus], train=train,
                       dp=dp)
  out = h * torch.sigmoid(gate)
  return l2_normalize(out) if normalize else out


def _batched_bn(gate, bns, *, train, dp=None):
  """The per-modality BatchNorms of gate [B, M, D] (the JAX package's
  _batched_torch_bn: no clamp of the variance)."""
  if train:
    mean, sq = _moments(gate, dp)                            # [M, Do]
    var = sq - mean * mean
    for i, bn in enumerate(bns):
      _update_running(bn, mean[i], var[i])
  else:
    mean = torch.stack([bn.running_mean for bn in bns])
    var = torch.stack([bn.running_var for bn in bns])
  scale = torch.stack([bn.weight for bn in bns])
  shift = torch.stack([bn.bias for bn in bns])
  return (gate - mean) * torch.rsqrt(var + BN_EPS) * scale + shift


def batched_reduce_dim(x, reducers, normalize=True):
  """All modalities' ReduceDims over one shared input x [B, D_in] ->
  [B, M, D_out] (txt_pro 'lin')."""
  w = torch.stack([r.fc.weight for r in reducers])           # [M, Do, Di]
  b = torch.stack([r.fc.bias for r in reducers])
  out = torch.einsum("bd,med->bme", x, w) + b
  return l2_normalize(out) if normalize else out


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
