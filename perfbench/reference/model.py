"""Plain fp32 PyTorch reference of the CENet the benchmark runs.

The Multi-modal Transformer of Gabeur et al. (ECCV 2020, arXiv:2007.10639)
at the switches its published MSRVTT and ActivityNet configurations set:
a BERT text tower read at its CLS token, one gated embedding unit with
BatchNorm per expert, MoE weights from the caption, the video BERT over
[CLS, one aggregated token per expert, every temporal token of every
expert] with token-type and temporal-position embeddings, expert outputs
read at the aggregated tokens, equal video weights, and the MoE
similarity.  Everything is float32 on plain torch operations, with
TF32 switched off by the caller (``precision``).

Parameters are a plain dict of tensors under the program's state-dict
names, so the benchmark can hand one set of weights made from the seed to
both sides.  Nothing here imports the program.

Train mode draws each dropout mask as ``rand(shape) >= p`` from the one
generator passed in, in the forward's order (text tower, the caption's
MoE head, video tower; in each layer the attention probabilities, the
attention output, then the FFN output), at the shape of the whole
activation.  Fed the same seed, it draws the masks a program drawing the
same way draws.  The video tokens are grouped [CLS, aggregated x M,
temporal x M x L] rather than interleaved per expert: with the types,
positions and mask permuted alike the transformer computes the same, and
the grouped order is the one the masks are drawn over.
"""

from __future__ import annotations

import contextlib
import math

import torch
import torch.nn.functional as F

# The switches the reference implements, at the published configurations'
# values; a configuration that sets another value is refused.
SWITCHES = {"txt_agg": "bertftn", "txt_pro": "gbn", "txt_wgh": "emb",
            "vid_inp": "both", "vid_cont": "bert", "vid_wgh": "none",
            "pos_enc": "tint", "out_tok": "mxp",
            "keep_missing_modalities": True, "normalize_experts": True}
BN_EPS = 1e-5
ZERO_GUARD = 1e-5


def check_config(cfg):
  """Raise unless ``cfg``'s switches are the ones implemented here."""
  wrong = {k: v for k, v in cfg["switches"].items() if SWITCHES.get(k) != v}
  missing = sorted(set(SWITCHES) - set(cfg["switches"]))
  if wrong or missing:
    raise ValueError(f"the reference implements {SWITCHES}; the "
                     f"configuration differs in {wrong}, lacks {missing}")


@contextlib.contextmanager
def precision(tf32):
  """Matrix products in full fp32 (``tf32`` False) or in TF32 (the
  control), restored on exit."""
  prev = (torch.backends.cuda.matmul.allow_tf32,
          torch.backends.cudnn.allow_tf32)
  torch.backends.cuda.matmul.allow_tf32 = tf32
  torch.backends.cudnn.allow_tf32 = tf32
  try:
    yield
  finally:
    (torch.backends.cuda.matmul.allow_tf32,
     torch.backends.cudnn.allow_tf32) = prev


def _bert_spec(prefix, b, ln, words):
  h, i, std = b["hidden_size"], b["intermediate_size"], b["initializer_range"]
  normal = ("normal", std)
  emb = [("word_embeddings", b["vocab_size"])] if words else []
  emb += [("position_embeddings", b["max_position_embeddings"]),
          ("token_type_embeddings", b["type_vocab_size"])]
  if not words:
    emb.reverse()
  spec = [(f"{prefix}.embeddings.{n}.weight", (rows, h), normal)
          for n, rows in emb]
  spec += [(f"{prefix}.embeddings.{ln}.weight", (h,), "ones"),
           (f"{prefix}.embeddings.{ln}.bias", (h,), "zeros")]
  for layer in range(b["num_hidden_layers"]):
    p = f"{prefix}.encoder.layer.{layer}."
    for name, (rows, cols) in (("attention.self.query", (h, h)),
                               ("attention.self.key", (h, h)),
                               ("attention.self.value", (h, h)),
                               ("attention.output.dense", (h, h)),
                               ("intermediate.dense", (i, h)),
                               ("output.dense", (h, i))):
      spec += [(p + name + ".weight", (rows, cols), normal),
               (p + name + ".bias", (rows,), "zeros")]
      if name in ("attention.output.dense", "output.dense"):
        norm = p + name.rsplit(".", 1)[0] + f".{ln}"
        spec += [(norm + ".weight", (h,), "ones"),
                 (norm + ".bias", (h,), "zeros")]
  return spec


def _linear_spec(name, fan_out, fan_in):
  return [(f"{name}.weight", (fan_out, fan_in), ("normal", fan_in ** -0.5)),
          (f"{name}.bias", (fan_out,), "zeros")]


def param_spec(cfg):
  """[(name, shape, init)] of every parameter and buffer, in the
  program's names.  ``init``: ("normal", std), "zeros", "ones" or
  "count" (an int64 zero).  The towers draw N(0, initializer_range), the
  heads N(0, 1/fan_in); biases are zero, LayerNorm and BatchNorm the
  identity, running statistics mean 0 and variance 1."""
  check_config(cfg)
  txt, vid, d = cfg["text_bert"], cfg["vid_bert"], cfg["same_dim"]
  mods = list(cfg["experts"])
  spec = _bert_spec("txt_bert", txt, "LayerNorm", True)
  for m in mods:
    spec += _linear_spec(f"text_GU.{m}.fc", d, txt["hidden_size"])
    spec += _linear_spec(f"text_GU.{m}.cg.fc", d, d)
    bn = f"text_GU.{m}.cg.batch_norm"
    spec += [(bn + ".weight", (d,), "ones"), (bn + ".bias", (d,), "zeros"),
             (bn + ".running_mean", (d,), "zeros"),
             (bn + ".running_var", (d,), "ones"),
             (bn + ".num_batches_tracked", (), "count")]
  for m in mods:
    spec += _linear_spec(f"video_dim_reduce.{m}.fc", d,
                         cfg["experts"][m]["dim"])
  spec += _bert_spec("vid_bert", vid, "layer_norm", False)
  for m in mods:
    spec += _linear_spec(f"moe_fc_txt.{m}", 1, txt["hidden_size"])
  return spec


def trainable(spec):
  """Names of the spec's trained parameters (not the BatchNorm
  buffers)."""
  return [n for n, _, _ in spec
          if not n.endswith(("running_mean", "running_var",
                             "num_batches_tracked"))]


class Dropout:
  """Masks rand(shape) >= p from one generator, in call order; the
  identity outside train mode or at p = 0 (no draw)."""

  def __init__(self, generator=None, train=False):
    self.generator, self.train = generator, train

  def __call__(self, x, p):
    if not self.train or p == 0.0:
      return x
    keep = torch.rand(x.shape, generator=self.generator,
                      device=x.device) >= p
    return torch.where(keep, x / (1.0 - p), torch.zeros_like(x))


def l2_normalize(x):
  return x / x.norm(dim=-1, keepdim=True).clamp_min(1e-12)


def _layer_norm(p, name, x, eps):
  return F.layer_norm(x, (x.shape[-1],), p[name + ".weight"],
                      p[name + ".bias"], eps)


def _linear(p, name, x):
  return x @ p[name + ".weight"].T + p[name + ".bias"]


def encoder(p, prefix, x, mask, b, ln, drop):
  """Post-LN BERT layers over x [N, S, H] with a {0, 1} mask [N, S]."""
  n, s, h = x.shape
  nh = b["num_attention_heads"]
  dh = h // nh
  bias = (1.0 - mask.float())[:, None, None, :] * -10000.0
  p_hidden, p_attn = b["hidden_dropout_prob"], b["attention_probs_dropout_prob"]
  eps = b["layer_norm_eps"]
  for layer in range(b["num_hidden_layers"]):
    q = f"{prefix}.encoder.layer.{layer}."
    heads = lambda name: _linear(p, q + name, x).view(n, s, nh, dh).transpose(1, 2)
    scores = (heads("attention.self.query")
              @ heads("attention.self.key").transpose(-1, -2)) / math.sqrt(dh)
    probs = drop(torch.softmax(scores + bias, -1), p_attn)
    ctx = (probs @ heads("attention.self.value")).transpose(1, 2).reshape(n, s, h)
    attn = drop(_linear(p, q + "attention.output.dense", ctx), p_hidden)
    x = _layer_norm(p, q + f"attention.output.{ln}", x + attn, eps)
    ffn = _linear(p, q + "output.dense",
                  F.gelu(_linear(p, q + "intermediate.dense", x)))
    x = _layer_norm(p, q + f"output.{ln}", x + drop(ffn, p_hidden), eps)
  return x


def _batch_norm(p, name, x, train):
  if train:
    mean, var = x.mean(0), x.var(0, unbiased=False)
  else:
    mean, var = p[name + ".running_mean"], p[name + ".running_var"]
  return ((x - mean) / torch.sqrt(var + BN_EPS) * p[name + ".weight"]
          + p[name + ".bias"])


def embed_text(p, cfg, token_ids, drop, train):
  """token_ids [B, K, T, 2] (ids, mask) -> text_embds [B, K, M, D],
  text_weights [B, K, M]."""
  txt = cfg["text_bert"]
  mods = list(cfg["experts"])
  b, k, t, _ = token_ids.shape
  ids = token_ids[..., 0].reshape(b * k, t).long()
  mask = token_ids[..., 1].reshape(b * k, t)
  e = "txt_bert.embeddings."
  x = (p[e + "word_embeddings.weight"][ids]
       + p[e + "position_embeddings.weight"][:t]
       + p[e + "token_type_embeddings.weight"][0])
  x = drop(_layer_norm(p, e + "LayerNorm", x, txt["layer_norm_eps"]),
           txt["hidden_dropout_prob"])
  cls = encoder(p, "txt_bert", x, mask, txt, "LayerNorm", drop)[:, 0]
  experts = []
  for m in mods:
    h = _linear(p, f"text_GU.{m}.fc", cls)
    gate = _batch_norm(p, f"text_GU.{m}.cg.batch_norm",
                       _linear(p, f"text_GU.{m}.cg.fc", h), train)
    experts.append(l2_normalize(h * torch.sigmoid(gate)))
  moe_in = drop(cls, txt["hidden_dropout_prob"])
  logits = torch.cat([_linear(p, f"moe_fc_txt.{m}", moe_in) for m in mods], 1)
  weights = torch.softmax(logits, 1)
  return {"text_embds": torch.stack(experts, 1).reshape(b, k, len(mods), -1),
          "text_weights": weights.reshape(b, k, len(mods))}


def embed_video(p, cfg, batch, drop):
  """Expert features -> vid_embds [B, M, D], vid_weights [B, M]."""
  vid = cfg["vid_bert"]
  mods = list(cfg["experts"])
  max_pos = vid["max_position_embeddings"] - 1
  reduce = lambda m, x: l2_normalize(_linear(p, f"video_dim_reduce.{m}.fc", x))
  agg = torch.stack([reduce(m, batch["features_maxpool"][m]) for m in mods], 1)
  b, nm, d = agg.shape
  present = torch.stack([batch["features_ind"][m].amax(1) for m in mods], 1)
  dev = agg.device
  feats = [torch.zeros(b, 1, d, device=dev), agg]
  types = [torch.zeros(1, dtype=torch.long, device=dev),
           torch.tensor([cfg["experts"][m]["idx"] for m in mods], device=dev)]
  pos = [torch.zeros(b, 1 + nm, dtype=torch.long, device=dev)]
  mask = [torch.ones(b, 1, device=dev), present.float()]
  for m in mods:
    f = batch["features"][m]
    feats.append(reduce(m, f))
    types.append(torch.full((f.shape[1],), cfg["experts"][m]["idx"],
                            dtype=torch.long, device=dev))
    pos.append(batch["features_t"][m].clamp(0, max_pos).long())
    mask.append(batch["features_ind"][m].float())
  e = "vid_bert.embeddings."
  x = (torch.cat(feats, 1) + p[e + "token_type_embeddings.weight"][torch.cat(types)]
       + p[e + "position_embeddings.weight"][torch.cat(pos, 1)])
  x = drop(_layer_norm(p, e + "layer_norm", x, vid["layer_norm_eps"]),
           vid["hidden_dropout_prob"])
  out = encoder(p, "vid_bert", x, torch.cat(mask, 1), vid, "layer_norm", drop)
  return {"vid_embds": l2_normalize(out[:, 1:1 + nm]),
          "vid_weights": torch.full((b, nm), 1.0 / nm, device=dev)}


def forward(p, cfg, batch, *, train=False, generator=None):
  """Both towers: {text_embds, text_weights, vid_embds, vid_weights}."""
  drop = Dropout(generator, train)
  return {**embed_text(p, cfg, batch["token_ids"], drop, train),
          **embed_video(p, cfg, batch, drop)}


def similarity(text_embds, text_weights, vid_embds, vid_weights):
  """MoE similarity [Q, V]: sum_m tw vw <t_m, v_m> / sum_m tw vw, from
  text_embds [Q, M, D], text_weights [Q, M], vid_embds [V, M, D] and
  vid_weights [V, M]."""
  q, m, d = text_embds.shape
  t = (text_embds * text_weights[..., None]).reshape(q, m * d)
  v = (vid_embds * vid_weights[..., None]).reshape(len(vid_embds), m * d)
  denom = text_weights @ vid_weights.T
  denom = torch.where(denom == 0, torch.full_like(denom, ZERO_GUARD), denom)
  return (t @ v.T) / denom


def max_margin_loss(sims, margin, fix_norm=True):
  """Bidirectional max-margin ranking loss with positives on the
  diagonal; ``fix_norm`` averages over the off-diagonal terms only."""
  n = sims.shape[0]
  diag = sims.diagonal()[:, None]
  terms = (torch.relu(margin - diag + sims)
           + torch.relu(margin - diag + sims.T))
  if fix_norm:
    terms = terms * (1.0 - torch.eye(n, device=sims.device))
    return terms.sum() / (2.0 * n * (n - 1))
  return terms.sum() / (2.0 * n * n)
