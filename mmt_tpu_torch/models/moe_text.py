"""Moonlight-16B-A3B's decoder (DeepSeek-V3's architecture) as MMT's
caption tower: CENet's ``txt_agg`` "moonlight" (models/cenet.py).

Equations, as the DeepSeek-V3 report (arXiv:2412.19437, section 2.1) and
the source's modeling_deepseek.py give them
(https://huggingface.co/moonshotai/Moonlight-16B-A3B):

* embedding of the caption ids (no position embedding), then layer 0
  (dense) and the MoE layers, each h = x + MLA(RMSNorm(x)), out = h +
  FFN(RMSNorm(h)), then a final RMSNorm (x rsqrt(mean x^2 + eps) w);
* MLA without q LoRA: q = W_q x [heads, nope + rope], split into q_nope,
  q_pe; [c_kv | k_pe] = W_kva x; k_nope, v = W_kvb RMSNorm(c_kv); RoPE
  (theta ``rope_theta``, no scaling) on q_pe and the head-shared k_pe,
  after the source's interleave permutation (pairs (2i, 2i + 1) to
  halves); softmax([q_nope|q_pe].[k_nope|k_pe] / sqrt(nope + rope)) v
  under the causal mask (and the caption's pads as keys), then W_o; no
  biases, no dropout (the source has none);
* dense layer: W_down (silu(W_gate x) * W_up x);
* MoE layer: s = sigmoid(W_r x) over all ``n_routed_experts``; the
  experts are the top-``num_experts_per_tok`` of s + b, b the correction
  bias (a buffer, no parameter); their weights g = s / (sum s + 1e-20) x
  ``routed_scaling_factor``; out = shared(x) + sum over the chosen experts
  held here of g_e E_e(x), the shared experts one SwiGLU of width
  ``n_shared_experts`` x ``moe_intermediate_size``;
* aux-loss-free balancing: after each train step (``update_biases``,
  called by train/step.py inside the step) b_i += gamma sign(mean load -
  load_i), the loads counted over the step's valid tokens; gamma
  (``BIAS_UPDATE_SPEED``) is the report's 1e-3, which the source's config
  does not carry;
* the sequence-wise balance loss alpha mean_caption sum_i f_i P_i (f_i =
  n_experts / (K T) x the caption's tokens that chose i, P_i the mean of
  s_i / sum_j s_j over them), added to MMT's loss; alpha is the
  deepseek_v3 config's ``aux_loss_alpha`` (0.001).

Departure: the caption embedding is the mean over the caption's valid
tokens of the final norm's output.  MMT's bertftn reads the CLS token,
but under the causal mask a first token sees only itself.

Expert share: the layer holds the experts ``experts_held`` (default
all), routes over all ``n_routed_experts`` and
computes only the held experts' part, through ops/moe.py (on the card the
grouped kernels, held in the train step's CUDA graph); what the absent
experts would add is left out.  No code stands in for the cards that
would hold them; the tower refuses data and tensor parallelism.

Counters: each MoE layer's ``expert_rows`` [n_experts] (int64, on the
device) adds the rows every expert took in each forward; ``selected``
holds the last forward's choices [T, K] (under a replayed step, the
graph's own buffer, which each replay fills).  Spans: ``mmt.tower.text.mla``
(a layer's attention), ``mmt.moe.route``, ``mmt.moe.experts``,
``mmt.moe.shared``.  Parameters and buffers carry the source's names
(``layers.{i}.self_attn.q_proj``, ``mlp.gate.e_score_correction_bias``,
...), but the held experts' weights, which are stacked: ``mlp.
experts_gate_up`` [E, 2 I, H] (gate row n at 2n, up row n at 2n + 1) and
``mlp.experts_down`` [E, H, I].
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from mmt_tpu_torch.ops import moe as moe_ops
from mmt_tpu_torch.utils.timing import span

KIND = "moonlight"
# gamma, the step of the routers' correction biases (the DeepSeek-V3
# report's; the source's config has no key for it).
BIAS_UPDATE_SPEED = 1e-3
# Keys of the source's config that name a mechanism this tower does not
# have, with the only value it takes.
FIXED = dict(attention_bias=False, hidden_act="silu", moe_layer_freq=1,
             q_lora_rank=None, scoring_func="sigmoid", topk_method="noaux_tc",
             n_group=1, topk_group=1, norm_topk_prob=True, seq_aux=True,
             num_nextn_predict_layers=0, ep_size=1, model_type="deepseek_v3",
             attention_dropout=0.0, rope_scaling=None, pretraining_tp=1)
# Keys read from the source and kept for the record only.
RECORDED = ("max_position_embeddings", "num_key_value_heads",
            "tie_word_embeddings")


@dataclasses.dataclass(frozen=True)
class TowerConfig:
  """The tower's geometry: the source's config.json keys and the experts
  held here.  Defaults are Moonlight-16B-A3B's, every expert held."""
  hidden_size: int = 2048
  num_hidden_layers: int = 27
  first_k_dense_replace: int = 1
  intermediate_size: int = 11264
  moe_intermediate_size: int = 1408
  n_routed_experts: int = 64
  num_experts_per_tok: int = 6
  n_shared_experts: int = 2
  num_attention_heads: int = 16
  kv_lora_rank: int = 512
  qk_nope_head_dim: int = 128
  qk_rope_head_dim: int = 64
  v_head_dim: int = 128
  rope_theta: float = 50000.0
  rms_norm_eps: float = 1e-5
  vocab_size: int = 163840
  routed_scaling_factor: float = 2.446
  experts_held: Optional[Tuple[int, ...]] = None
  aux_loss_alpha: float = 0.001
  initializer_range: float = 0.02

  @classmethod
  def from_dict(cls, d):
    d = dict(d)
    wrong = {k: d[k] for k in FIXED if k in d and d[k] != FIXED[k]}
    if wrong:
      raise ValueError(f"the {KIND} tower implements {FIXED}; the config "
                       f"sets {wrong}")
    fields = {f.name for f in dataclasses.fields(cls)}
    unknown = sorted(set(d) - fields - set(FIXED) - set(RECORDED))
    if unknown:
      raise ValueError(f"unknown {KIND} tower keys {unknown}")
    kv = d.get("num_key_value_heads")
    if kv is not None and kv != d.get("num_attention_heads",
                                      cls.num_attention_heads):
      raise ValueError("MLA has as many key/value heads as query heads")
    kept = {k: v for k, v in d.items() if k in fields}
    if kept.get("experts_held") is not None:
      kept["experts_held"] = tuple(int(e) for e in kept["experts_held"])
    return cls(**kept)

  @property
  def held(self):
    """The ids of the routed experts held here, in slot order."""
    held = self.experts_held
    if held is None:
      held = tuple(range(self.n_routed_experts))
    if (not held or len(set(held)) != len(held)
        or not all(0 <= e < self.n_routed_experts for e in held)):
      raise ValueError(f"experts held {held}: distinct ids below "
                       f"{self.n_routed_experts}")
    return held


class RMSNorm(nn.Module):

  def __init__(self, dim, eps, device=None):
    super().__init__()
    self.weight = nn.Parameter(torch.ones(dim, device=device))
    self.eps = eps

  def forward(self, x):
    return (x * torch.rsqrt(x.pow(2).mean(-1, keepdim=True) + self.eps)
            * self.weight)


def _linear(fan_in, fan_out, device):
  return nn.Linear(fan_in, fan_out, bias=False, device=device)


def rope_tables(seq, dim, theta, device):
  """(cos, sin) [seq, dim] of positions 0 .. seq - 1 (the source's
  rotary embedding without scaling)."""
  inv = 1.0 / theta ** (torch.arange(0, dim, 2, device=device,
                                     dtype=torch.float32) / dim)
  freqs = torch.outer(torch.arange(seq, device=device, dtype=torch.float32),
                      inv)
  emb = torch.cat([freqs, freqs], -1)
  return emb.cos(), emb.sin()


def apply_rope(x, cos, sin):
  """RoPE on x [..., S, d] after the source's permutation of each pair
  (2i, 2i + 1) to (i, i + d / 2)."""
  *lead, s, d = x.shape
  x = x.reshape(*lead, s, d // 2, 2).transpose(-1, -2).reshape(*lead, s, d)
  rotated = torch.cat([-x[..., d // 2:], x[..., :d // 2]], -1)
  return x * cos + rotated * sin


class LatentAttention(nn.Module):
  """MLA without q LoRA (q_lora_rank null)."""

  def __init__(self, c: TowerConfig, device=None):
    super().__init__()
    h, nh = c.hidden_size, c.num_attention_heads
    self.c = c
    self.q_proj = _linear(h, nh * (c.qk_nope_head_dim + c.qk_rope_head_dim),
                          device)
    self.kv_a_proj_with_mqa = _linear(h, c.kv_lora_rank + c.qk_rope_head_dim,
                                      device)
    self.kv_a_layernorm = RMSNorm(c.kv_lora_rank, c.rms_norm_eps, device)
    self.kv_b_proj = _linear(c.kv_lora_rank,
                             nh * (c.qk_nope_head_dim + c.v_head_dim), device)
    self.o_proj = _linear(nh * c.v_head_dim, h, device)

  def forward(self, x, bias, cos, sin):
    c = self.c
    b, s, _ = x.shape
    nh, nope, rope = c.num_attention_heads, c.qk_nope_head_dim, c.qk_rope_head_dim
    q = self.q_proj(x).view(b, s, nh, nope + rope).transpose(1, 2)
    q_nope, q_pe = q.split([nope, rope], -1)
    c_kv, k_pe = self.kv_a_proj_with_mqa(x).split([c.kv_lora_rank, rope], -1)
    kv = self.kv_b_proj(self.kv_a_layernorm(c_kv)).view(
        b, s, nh, nope + c.v_head_dim).transpose(1, 2)
    k_nope, v = kv.split([nope, c.v_head_dim], -1)
    q_pe = apply_rope(q_pe, cos, sin)
    k_pe = apply_rope(k_pe.view(b, 1, s, rope), cos, sin)
    q = torch.cat([q_nope, q_pe], -1)
    k = torch.cat([k_nope, k_pe.expand(b, nh, s, rope)], -1)
    scores = q @ k.transpose(-1, -2) * (nope + rope) ** -0.5 + bias
    ctx = torch.softmax(scores, -1) @ v
    return self.o_proj(ctx.transpose(1, 2).reshape(b, s, nh * c.v_head_dim))


class SwiGLU(nn.Module):

  def __init__(self, hidden, inter, device=None):
    super().__init__()
    self.gate_proj = _linear(hidden, inter, device)
    self.up_proj = _linear(hidden, inter, device)
    self.down_proj = _linear(inter, hidden, device)

  def forward(self, x):
    return self.down_proj(F.silu(self.gate_proj(x)) * self.up_proj(x))


class Router(nn.Module):
  """The gate's weight [n_experts, H] and correction bias [n_experts]."""

  def __init__(self, c: TowerConfig, device=None):
    super().__init__()
    self.weight = nn.Parameter(torch.empty(c.n_routed_experts, c.hidden_size,
                                           device=device))
    self.register_buffer("e_score_correction_bias",
                         torch.zeros(c.n_routed_experts, device=device))


class RoutedMoE(nn.Module):
  """The MoE FFN over the held experts (see the module)."""

  def __init__(self, c: TowerConfig, device=None):
    super().__init__()
    held, h, i = c.held, c.hidden_size, c.moe_intermediate_size
    self.c = c
    self.gate = Router(c, device)
    self.experts_gate_up = nn.Parameter(torch.empty(len(held), 2 * i, h,
                                                    device=device))
    self.experts_down = nn.Parameter(torch.empty(len(held), h, i,
                                                 device=device))
    self.shared_experts = SwiGLU(h, i * c.n_shared_experts, device)
    slot_of = torch.full((c.n_routed_experts,), len(held), dtype=torch.long)
    slot_of[list(held)] = torch.arange(len(held))
    self.register_buffer("slot_of", slot_of.to(device), persistent=False)
    self.register_buffer("expert_rows", torch.zeros(
        c.n_routed_experts, dtype=torch.long, device=device),
                         persistent=False)
    # The loads of the last train forward, which the bias update reads.
    self.register_buffer("step_loads", torch.zeros(
        c.n_routed_experts, device=device), persistent=False)
    self.selected = None

  def route(self, x, valid):
    """(scores s [T, n], choices [T, K], weights g [T, K], loads [n]) of
    the tokens x [T, H] with the {0, 1} mask ``valid`` [T]."""
    c = self.c
    scores = torch.sigmoid(F.linear(x, self.gate.weight))
    sel = torch.topk(scores.detach() + self.gate.e_score_correction_bias,
                     c.num_experts_per_tok, dim=-1).indices
    weights = scores.gather(1, sel)
    weights = (weights / (weights.sum(-1, keepdim=True) + 1e-20)
               * c.routed_scaling_factor)
    loads = torch.zeros(c.n_routed_experts, device=x.device).scatter_add_(
        0, sel.reshape(-1),
        valid[:, None].expand(-1, sel.shape[1]).reshape(-1))
    return scores, sel, weights, loads

  def balance_loss(self, scores, sel, valid, b):
    """alpha x the mean over the b captions of sum_i f_i P_i."""
    c = self.c
    n, k = c.n_routed_experts, c.num_experts_per_tok
    t = valid.numel() // b
    mask = valid.view(b, t, 1)
    count = mask.sum(1).clamp_min(1.0)                              # [b, 1]
    probs = (scores / scores.sum(-1, keepdim=True)).view(b, t, n)
    p = (probs * mask).sum(1) / count
    hits = torch.zeros_like(scores).scatter_(1, sel, 1.0).view(b, t, n)
    f = (hits * mask).sum(1) * (n / k) / count
    return c.aux_loss_alpha * (f * p).sum(1).mean()

  def forward(self, x, valid, train):
    """x [B, S, H], valid [B, S] -> (out [B, S, H], balance loss or
    None)."""
    b, s, h = x.shape
    flat = x.reshape(b * s, h)
    valid = valid.reshape(-1).float()
    with span("mmt.moe.route"):
      scores, sel, weights, loads = self.route(flat, valid)
      self.expert_rows += torch.zeros_like(self.expert_rows).scatter_add_(
          0, sel.reshape(-1), torch.ones_like(sel.reshape(-1)))
      self.selected = sel
      aux = None
      if train:
        self.step_loads.copy_(loads)
        aux = self.balance_loss(scores, sel, valid, b)
    with span("mmt.moe.experts"):
      routed = moe_ops.grouped_experts(flat, weights, sel,
                                       self.experts_gate_up,
                                       self.experts_down, self.slot_of)
    with span("mmt.moe.shared"):
      shared = self.shared_experts(flat)
    return (routed + shared).view(b, s, h), aux

  @torch.no_grad()
  def update_bias(self):
    """b += gamma sign(mean load - load) from the last train forward."""
    self.gate.e_score_correction_bias.add_(
        torch.sign(self.step_loads.mean() - self.step_loads),
        alpha=BIAS_UPDATE_SPEED)


class DecoderLayer(nn.Module):

  def __init__(self, c: TowerConfig, index, device=None):
    super().__init__()
    self.input_layernorm = RMSNorm(c.hidden_size, c.rms_norm_eps, device)
    self.self_attn = LatentAttention(c, device)
    self.post_attention_layernorm = RMSNorm(c.hidden_size, c.rms_norm_eps,
                                            device)
    self.moe = index >= c.first_k_dense_replace
    self.mlp = (RoutedMoE(c, device) if self.moe
                else SwiGLU(c.hidden_size, c.intermediate_size, device))

  def forward(self, x, bias, cos, sin, valid, train):
    with span("mmt.tower.text.mla"):
      x = x + self.self_attn(self.input_layernorm(x), bias, cos, sin)
    h = self.post_attention_layernorm(x)
    if self.moe:
      out, aux = self.mlp(h, valid, train)
    else:
      out, aux = self.mlp(h), None
    return x + out, aux


class MoETextTower(nn.Module):
  """ids, mask [N, S] -> (the mean of the final norm's output over each
  caption's valid tokens [N, H], the summed balance loss or None)."""

  def __init__(self, c: TowerConfig, device=None):
    super().__init__()
    self.cfg = c
    self.embed_tokens = nn.Embedding(c.vocab_size, c.hidden_size,
                                     device=device)
    self.layers = nn.ModuleList(DecoderLayer(c, i, device)
                                for i in range(c.num_hidden_layers))
    self.norm = RMSNorm(c.hidden_size, c.rms_norm_eps, device)

  def moe_layers(self):
    return [layer.mlp for layer in self.layers if layer.moe]

  def init_weights(self, generator):
    """Every projection, expert and the embedding ~ N(0,
    initializer_range) (the source's init); norms one, biases zero."""
    std = self.cfg.initializer_range
    with torch.no_grad():
      for name, p in self.named_parameters():
        if not name.endswith("norm.weight"):
          p.normal_(0.0, std, generator=generator)
      for moe in self.moe_layers():
        moe.gate.e_score_correction_bias.zero_()
    return self

  def forward(self, ids, mask, train=False):
    c = self.cfg
    n, s = ids.shape
    dev = ids.device
    x = self.embed_tokens(ids)
    cos, sin = rope_tables(s, c.qk_rope_head_dim, c.rope_theta, dev)
    pos = torch.arange(s, device=dev)
    # Causal, the caption's pads masked as keys; a pad row keeps itself.
    allowed = ((pos[None, :] <= pos[:, None])[None]
               & ((mask[:, None, :] != 0) | torch.eye(s, dtype=torch.bool,
                                                      device=dev)[None]))
    bias = torch.zeros(allowed.shape, device=dev).masked_fill(
        ~allowed, torch.finfo(torch.float32).min)[:, None]
    aux = None
    for layer in self.layers:
      x, layer_aux = layer(x, bias, cos, sin, mask, train)
      if layer_aux is not None:
        aux = layer_aux if aux is None else aux + layer_aux
    x = self.norm(x)
    m = mask.float()[..., None]
    return (x * m).sum(1) / m.sum(1).clamp_min(1.0), aux

  @torch.no_grad()
  def update_biases(self):
    for moe in self.moe_layers():
      moe.update_bias()
