"""Transformer encoder for the video and text towers.

Port of mmt_tpu/models/bert.py: post-LN blocks, erf-GELU, the additive
-10000 mask, fp32 LayerNorm statistics with the fast-variance form.  The
FFN sub-block goes through ``ops.ffn.ffn_block`` in eval mode and
``ops.ffn.ffn_block_train`` in train mode (the fused kernels on the card).
Train mode (``train=True`` with a ``torch.Generator``) adds dropout where
JAX has it: after the embeddings' LayerNorm, on the attention
probabilities, on the attention output before the residual, and as the
FFN block's mask; at rate 0 the FFN still takes the train block, with a
ones mask.  Modules carry the reference's torch state-dict names
(``encoder.layer.{i}.attention.self.query``, ``intermediate.dense``,
``output.LayerNorm`` for the text tower and ``output.layer_norm`` for the
video tower, ...), so the reference's checkpoints load by name.

Parameters are fp32; matmul operands are rounded to ``compute_dtype``
(bf16 on the card) with fp32 accumulation, as the JAX package computes.

With a ``tp`` (``parallel.TensorParallel``) each layer holds this rank's
shards in the Megatron layout of ``parallel.mesh``: q/k/v column-parallel
(heads / size local heads, behind Megatron's f), the attention's output
projection row-parallel (an fp32 partial, g, then the bias), and the FFN
through ``ffn_block_tp`` / ``ffn_block_train(tp=...)``.  Attention stays
replicated when the head count does not divide by the size, the FFN when
the intermediate size does not (the JAX package's ``heads_ok``); the
layer's ``shard_dims`` says which parameters it splits.  Every rank draws each dropout mask at
its full size, in the single-device order, and keeps its heads' slice of
the attention-probability mask, so the ranks stay the single-device
model split.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from mmt_tpu_torch.config import BertParams
from mmt_tpu_torch.ops import attention as attention_ops
from mmt_tpu_torch.ops import ffn as ffn_ops
from mmt_tpu_torch.ops.dropout import dropout, dropout_mask
from mmt_tpu_torch.parallel import mesh as tp_lib


class Linear(nn.Linear):
  """nn.Linear that keeps its weight and bias cast to a compute dtype.

  Without autograd (``no_grad`` / ``inference_mode``) the cast copy is
  made on first use and remade only when the parameters change (a load,
  an in-place update or a move), never on every call.  Under autograd the
  copy is made in the graph on every call, so that gradients reach the
  fp32 parameters.
  """

  def __init__(self, in_features, out_features, *, device=None):
    super().__init__(in_features, out_features, device=device)
    self._cast = None

  def cast(self, dtype):
    w, b = self.weight, self.bias
    if torch.is_grad_enabled() and (w.requires_grad or b.requires_grad):
      return w.to(dtype), b.to(dtype)
    key = (dtype, w.data_ptr(), w._version, b.data_ptr(), b._version)
    if self._cast is None or self._cast[0] != key:
      self._cast = (key, w.detach().to(dtype).contiguous(),
                    b.detach().to(dtype))
    return self._cast[1], self._cast[2]


def _container(**children):
  mod = nn.Module()
  for name, child in children.items():
    mod.add_module(name, child)
  return mod


def init_normal_(module: nn.Module, generator: torch.Generator, std: float):
  """BERT initialisation: Linear/Embedding weights ~ N(0, std), zero
  Linear biases (LayerNorm keeps its construction defaults)."""
  with torch.no_grad():
    for mod in module.modules():
      if isinstance(mod, (nn.Linear, nn.Embedding)):
        mod.weight.normal_(0.0, std, generator=generator)
      if isinstance(mod, nn.Linear):
        mod.bias.zero_()


def attention_bias_from_mask(attention_mask):
  """[B, S] {0,1} mask -> [B, 1, 1, S] additive bias, -10000 at pads."""
  return ((1.0 - attention_mask.float()) * -10000.0)[:, None, None, :]


class TransformerLayer(nn.Module):
  """Post-LN encoder block: attention -> add&norm -> fused FFN block."""

  def __init__(self, cfg: BertParams, ln_name: str, *, compute_dtype,
               device=None, tp=None):
    super().__init__()
    if cfg.hidden_act != "gelu":
      raise NotImplementedError(f"hidden_act {cfg.hidden_act!r}")
    h, i = cfg.hidden_size, cfg.intermediate_size
    self.cfg, self.ln_name, self.compute_dtype = cfg, ln_name, compute_dtype
    mp = tp.size if tp is not None else 1
    self.tp = tp if mp > 1 else None
    self.attn_tp = self.tp is not None and cfg.num_attention_heads % mp == 0
    self.ffn_tp = self.tp is not None and i % mp == 0
    ha = h // mp if self.attn_tp else h      # this rank's q/k/v width
    il = i // mp if self.ffn_tp else i       # this rank's FFN width
    ln = lambda: nn.LayerNorm(h, eps=cfg.layer_norm_eps, device=device)
    self.attention = _container(
        self=_container(query=Linear(h, ha, device=device),
                        key=Linear(h, ha, device=device),
                        value=Linear(h, ha, device=device)),
        output=_container(dense=Linear(ha, h, device=device),
                          **{ln_name: ln()}))
    self.intermediate = _container(dense=Linear(h, il, device=device))
    self.output = _container(dense=Linear(il, h, device=device),
                             **{ln_name: ln()})

  @property
  def shard_dims(self):
    """{parameter name: the dim it is split on} of this layer's
    tensor-parallel shards (column-parallel weights and biases on dim 0,
    row-parallel weights on dim 1); the rest is replicated."""
    dims = {}
    if self.attn_tp:
      for n in ("query", "key", "value"):
        dims[f"attention.self.{n}.weight"] = 0
        dims[f"attention.self.{n}.bias"] = 0
      dims["attention.output.dense.weight"] = 1
    if self.ffn_tp:
      dims.update({"intermediate.dense.weight": 0,
                   "intermediate.dense.bias": 0, "output.dense.weight": 1})
    return dims

  def forward(self, hidden, attn_bias, *, train=False, generator=None):
    cfg, cd, tp = self.cfg, self.compute_dtype, self.tp
    p_hidden = cfg.hidden_dropout_prob if train else 0.0
    b, s, h = hidden.shape
    n_heads, head_range = cfg.num_attention_heads, None
    hc = hidden.to(cd)
    if self.attn_tp:
      n_heads //= tp.size
      head_range = (tp.rank * n_heads, cfg.num_attention_heads)
      hc = tp_lib.copy_to_tp(hc, tp)

    def heads(lin):
      w, bias = lin.cast(cd)
      return F.linear(hc, w, bias).view(b, s, n_heads, -1).transpose(1, 2)

    sa = self.attention.self
    ctx = attention_ops.attention_bhsd(
        heads(sa.query), heads(sa.key), heads(sa.value), attn_bias=attn_bias,
        dropout_p=cfg.attention_probs_dropout_prob if train else 0.0,
        generator=generator, heads=head_range)
    ctx = ctx.transpose(1, 2).reshape(b, s, -1).to(cd)
    wo, bo = self.attention.output.dense.cast(cd)
    if self.attn_tp:
      attn_out = (tp_lib.reduce_from_tp(ctx.float() @ wo.float().T, tp)
                  + bo.float()).to(cd)
    else:
      attn_out = F.linear(ctx, wo, bo)
    attn_out = dropout(attn_out, p_hidden, generator)
    attn_ln = getattr(self.attention.output, self.ln_name)
    hidden = ffn_ops.layer_norm(attn_out.float() + hidden,
                                attn_ln.weight, attn_ln.bias,
                                eps=cfg.layer_norm_eps)

    inter, out = self.intermediate.dense, self.output.dense
    ffn_ln = getattr(self.output, self.ln_name)
    ffn_tp = tp if self.ffn_tp else None
    if train:
      drop = dropout_mask(hidden.shape, p_hidden, generator, hidden.device)
      return ffn_ops.ffn_block_train(
          hidden, drop, inter.weight, inter.bias, out.weight, out.bias,
          ffn_ln.weight, ffn_ln.bias, eps=cfg.layer_norm_eps,
          compute_dtype=cd, tp=ffn_tp)
    w1, _ = inter.cast(cd)
    w2, _ = out.cast(cd)
    args = (hidden, w1, inter.bias, w2, out.bias, ffn_ln.weight, ffn_ln.bias)
    if ffn_tp is not None:
      return ffn_ops.ffn_block_tp(*args, eps=cfg.layer_norm_eps, tp=ffn_tp,
                                  compute_dtype=cd)
    return ffn_ops.ffn_block(*args, eps=cfg.layer_norm_eps, compute_dtype=cd)


def shard_dims(module: nn.Module):
  """{parameter name: the dim it is split on} of the tensor-parallel
  shards of every ``TransformerLayer`` in ``module`` (the names are
  ``module``'s own); the parameters left out are replicated."""
  return {f"{prefix}.{name}": dim
          for prefix, layer in module.named_modules()
          if isinstance(layer, TransformerLayer)
          for name, dim in layer.shard_dims.items()}


def _encode(bert, x, attention_mask, train, generator):
  """Embedding dropout (train mode), then the encoder."""
  p = bert.cfg.hidden_dropout_prob if train else 0.0
  return bert.encoder(dropout(x, p, generator),
                      attention_bias_from_mask(attention_mask), train=train,
                      generator=generator)


class TransformerEncoder(nn.Module):

  def __init__(self, cfg: BertParams, ln_name: str, *, compute_dtype,
               device=None, tp=None):
    super().__init__()
    self.layer = nn.ModuleList(
        TransformerLayer(cfg, ln_name, compute_dtype=compute_dtype,
                         device=device, tp=tp)
        for _ in range(cfg.num_hidden_layers))

  def forward(self, hidden, attn_bias, *, train=False, generator=None):
    for layer in self.layer:
      hidden = layer(hidden, attn_bias, train=train, generator=generator)
    return hidden


class FeatureBert(nn.Module):
  """Video BERT: embeddings = token type + position + continuous features
  (no word table), then LayerNorm.  Reference names: ``embeddings.
  {position_embeddings, token_type_embeddings, layer_norm}``."""

  def __init__(self, cfg: BertParams, *, compute_dtype, device=None,
               tp=None):
    super().__init__()
    h = cfg.hidden_size
    self.cfg, self.compute_dtype = cfg, compute_dtype
    self.embeddings = _container(
        position_embeddings=nn.Embedding(cfg.max_position_embeddings, h,
                                         device=device),
        token_type_embeddings=nn.Embedding(cfg.type_vocab_size, h,
                                           device=device),
        layer_norm=nn.LayerNorm(h, eps=cfg.layer_norm_eps, device=device))
    self.encoder = TransformerEncoder(cfg, "layer_norm",
                                      compute_dtype=compute_dtype,
                                      device=device, tp=tp)

  def forward(self, features, attention_mask, token_type_ids, position_ids,
              *, train=False, generator=None):
    cd, emb = self.compute_dtype, self.embeddings
    x = emb.token_type_embeddings.weight[token_type_ids].to(cd)
    x = x + features.to(cd)
    x = x + emb.position_embeddings.weight[position_ids].to(cd)
    x = ffn_ops.layer_norm(x, emb.layer_norm.weight, emb.layer_norm.bias,
                           eps=self.cfg.layer_norm_eps)
    return _encode(self, x, attention_mask, train, generator)


class TextBert(nn.Module):
  """Text BERT (bert-base-cased geometry): word + position + type lookup.
  Reference (HF) names: ``embeddings.{word_embeddings,
  position_embeddings, token_type_embeddings, LayerNorm}``."""

  def __init__(self, cfg: BertParams, *, compute_dtype, device=None,
               tp=None):
    super().__init__()
    h = cfg.hidden_size
    self.cfg, self.compute_dtype = cfg, compute_dtype
    self.embeddings = _container(
        word_embeddings=nn.Embedding(cfg.vocab_size, h, device=device),
        position_embeddings=nn.Embedding(cfg.max_position_embeddings, h,
                                         device=device),
        token_type_embeddings=nn.Embedding(cfg.type_vocab_size, h,
                                           device=device),
        LayerNorm=nn.LayerNorm(h, eps=cfg.layer_norm_eps, device=device))
    self.encoder = TransformerEncoder(cfg, "LayerNorm",
                                      compute_dtype=compute_dtype,
                                      device=device, tp=tp)

  def forward(self, input_ids, attention_mask, token_type_ids, position_ids,
              *, train=False, generator=None):
    cd, emb = self.compute_dtype, self.embeddings
    x = (emb.word_embeddings.weight[input_ids].to(cd)
         + emb.position_embeddings.weight[position_ids].to(cd)
         + emb.token_type_embeddings.weight[token_type_ids].to(cd))
    x = ffn_ops.layer_norm(x, emb.LayerNorm.weight, emb.LayerNorm.bias,
                           eps=self.cfg.layer_norm_eps)
    return _encode(self, x, attention_mask, train, generator)
