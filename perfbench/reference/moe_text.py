"""Plain fp32 PyTorch reference of MMT with Moonlight-16B-A3B's decoder as
its caption tower (the program's CENet ``txt_agg`` "moonlight").

The tower (DeepSeek-V3's architecture, arXiv:2412.19437 section 2.1, and
the source's modeling_deepseek.py at
https://huggingface.co/moonshotai/Moonlight-16B-A3B): the caption ids'
embedding; layer 0 dense and the others MoE, each h = x + MLA(RMSNorm(x)),
out = h + FFN(RMSNorm(h)); a final RMSNorm; the mean over the caption's
valid tokens (a departure: MMT reads BERT's CLS, which under the causal
mask sees only itself).  MLA without q LoRA, RoPE after the source's
pair permutation, the causal mask (and the caption's pads as keys),
softmax scale 1 / sqrt(nope + rope).  The MoE layer: s = sigmoid(W_r x),
the top-K of s + b (b the correction bias), weights s / (sum s + 1e-20) x
the routed scaling factor, the shared SwiGLU plus the chosen experts held
here, each by a loop over its tokens.  The experts held elsewhere add
nothing, here as in the program.  After each step b += gamma sign(mean
load - load); the sequence-wise balance loss alpha mean_caption sum_i f_i
P_i joins MMT's max-margin loss.  The rest of MMT (the GEU heads, the MoE
weight heads and their dropout, the video tower, the similarity and the
loss) is ``reference/model.py``'s.  Nothing here imports the program.

The check routes with the program's choices: a top-K of 64 sigmoid
scores picked in fp32 flips on rounding at near ties, and a flipped
choice changes a whole caption through causal attention, so a reference
routed on its own would not be comparable.  ``train_steps`` takes the
program's choices of each checked step and layer and reports how far they
are from its own top-K (``route_gap``: the largest amount by which a
chosen expert's s + b falls below an unchosen one's; 0 for an exact
top-K); everything else then follows those choices.

Parameters are a dict under the program's state-dict names; the held
experts' gate and up weights are one [E, 2 I, H] tensor (gate row n at 2n,
up row n at 2n + 1), the down weights [E, H, I].
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from perfbench.reference import model as ref_model
from perfbench.reference import train as ref_train

TOWER = "txt_tower"
# The MMT switches of the configuration (reference/model.py's, but the
# caption tower).
SWITCHES = dict(ref_model.SWITCHES, txt_agg="moonlight")
# gamma, the step of the correction biases (the DeepSeek-V3 report's).
BIAS_UPDATE_SPEED = 1e-3
# The tower's keys of a configuration file: the source's config.json keys
# it reads, the experts held here and the init.
GEOMETRY = ("hidden_size", "num_hidden_layers", "first_k_dense_replace",
            "intermediate_size", "moe_intermediate_size", "n_routed_experts",
            "num_experts_per_tok", "n_shared_experts", "num_attention_heads",
            "kv_lora_rank", "qk_nope_head_dim", "qk_rope_head_dim",
            "v_head_dim", "rope_theta", "rms_norm_eps", "vocab_size",
            "routed_scaling_factor", "experts_held", "aux_loss_alpha",
            "initializer_range")


def geometry(cfg):
  """The tower's geometry {key: value} from a configuration file."""
  return {k: cfg[k] for k in GEOMETRY if k in cfg}


def held(g):
  return list(g.get("experts_held") or range(g["n_routed_experts"]))


def moe_layers(g):
  return list(range(g["first_k_dense_replace"], g["num_hidden_layers"]))


def tower_spec(g):
  """[(name, shape, init)] of the tower's parameters and buffers."""
  h, nh = g["hidden_size"], g["num_attention_heads"]
  nope, rope, vd = (g["qk_nope_head_dim"], g["qk_rope_head_dim"],
                    g["v_head_dim"])
  lora, i = g["kv_lora_rank"], g["moe_intermediate_size"]
  normal = ("normal", g.get("initializer_range", 0.02))
  spec = [(f"{TOWER}.embed_tokens.weight", (g["vocab_size"], h), normal)]
  for layer in range(g["num_hidden_layers"]):
    p = f"{TOWER}.layers.{layer}."
    spec += [(p + "input_layernorm.weight", (h,), "ones"),
             (p + "self_attn.q_proj.weight", (nh * (nope + rope), h), normal),
             (p + "self_attn.kv_a_proj_with_mqa.weight", (lora + rope, h),
              normal),
             (p + "self_attn.kv_a_layernorm.weight", (lora,), "ones"),
             (p + "self_attn.kv_b_proj.weight", (nh * (nope + vd), lora),
              normal),
             (p + "self_attn.o_proj.weight", (h, nh * vd), normal),
             (p + "post_attention_layernorm.weight", (h,), "ones")]
    if layer in moe_layers(g):
      e, n = len(held(g)), g["n_routed_experts"]
      shared = i * g["n_shared_experts"]
      spec += [(p + "mlp.gate.weight", (n, h), normal),
               (p + "mlp.gate.e_score_correction_bias", (n,), "zeros"),
               (p + "mlp.experts_gate_up", (e, 2 * i, h), normal),
               (p + "mlp.experts_down", (e, h, i), normal)]
      width = shared
      p += "mlp.shared_experts."
    else:
      width = g["intermediate_size"]
      p += "mlp."
    spec += [(p + "gate_proj.weight", (width, h), normal),
             (p + "up_proj.weight", (width, h), normal),
             (p + "down_proj.weight", (h, width), normal)]
  return spec + [(f"{TOWER}.norm.weight", (h,), "ones")]


def param_spec(cfg):
  """[(name, shape, init)] of every parameter and buffer of the program's
  CENet at ``cfg``: the tower, then reference/model.py's heads and video
  tower at the tower's width."""
  wrong = {k: v for k, v in cfg["switches"].items() if SWITCHES.get(k) != v}
  if wrong or set(SWITCHES) - set(cfg["switches"]):
    raise ValueError(f"the reference implements {SWITCHES}; the "
                     f"configuration differs in {wrong}")
  g = geometry(cfg)
  h, d, mods = g["hidden_size"], cfg["same_dim"], list(cfg["experts"])
  spec = tower_spec(g)
  for m in mods:
    spec += ref_model._linear_spec(f"text_GU.{m}.fc", d, h)
    spec += ref_model._linear_spec(f"text_GU.{m}.cg.fc", d, d)
    bn = f"text_GU.{m}.cg.batch_norm"
    spec += [(bn + ".weight", (d,), "ones"), (bn + ".bias", (d,), "zeros"),
             (bn + ".running_mean", (d,), "zeros"),
             (bn + ".running_var", (d,), "ones"),
             (bn + ".num_batches_tracked", (), "count")]
  for m in mods:
    spec += ref_model._linear_spec(f"video_dim_reduce.{m}.fc", d,
                                   cfg["experts"][m]["dim"])
  spec += ref_model._bert_spec("vid_bert", cfg["vid_bert"], "layer_norm",
                               False)
  for m in mods:
    spec += ref_model._linear_spec(f"moe_fc_txt.{m}", 1, h)
  return spec


def trainable(spec):
  """The spec's trained parameters: not BatchNorm's statistics, not the
  routers' correction biases."""
  return [n for n in ref_model.trainable(spec)
          if not n.endswith("e_score_correction_bias")]


def rms_norm(x, w, eps):
  return x * torch.rsqrt(x.pow(2).mean(-1, keepdim=True) + eps) * w


def rope(x, seq, theta):
  """RoPE over positions 0 .. seq - 1 of x [..., seq, d], each pair (2i,
  2i + 1) first moved to (i, i + d / 2), as the source does."""
  d = x.shape[-1]
  inv = 1.0 / theta ** (torch.arange(0, d, 2, dtype=torch.float32,
                                     device=x.device) / d)
  ang = torch.arange(seq, dtype=torch.float32, device=x.device)[:, None] * inv
  cos, sin = torch.cat([ang, ang], -1).cos(), torch.cat([ang, ang], -1).sin()
  x = torch.cat([x[..., 0::2], x[..., 1::2]], -1)
  half = d // 2
  return x * cos + torch.cat([-x[..., half:], x[..., :half]], -1) * sin


def mla(p, pre, g, x, mask):
  """Latent attention of x [N, S, H] with the caption mask [N, S]."""
  n, s, _ = x.shape
  nh, nope, rd, vd = (g["num_attention_heads"], g["qk_nope_head_dim"],
                      g["qk_rope_head_dim"], g["v_head_dim"])
  q = (x @ p[pre + "q_proj.weight"].T).view(n, s, nh, nope + rd).transpose(1, 2)
  kva = x @ p[pre + "kv_a_proj_with_mqa.weight"].T
  c_kv, k_pe = kva[..., :g["kv_lora_rank"]], kva[..., g["kv_lora_rank"]:]
  kv = (rms_norm(c_kv, p[pre + "kv_a_layernorm.weight"], g["rms_norm_eps"])
        @ p[pre + "kv_b_proj.weight"].T).view(n, s, nh, nope + vd).transpose(1, 2)
  theta = g["rope_theta"]
  q = torch.cat([q[..., :nope], rope(q[..., nope:], s, theta)], -1)
  k_pe = rope(k_pe[:, None], s, theta).expand(n, nh, s, rd)
  k = torch.cat([kv[..., :nope], k_pe], -1)
  scores = (q @ k.transpose(-1, -2)) / math.sqrt(nope + rd)
  idx = torch.arange(s, device=x.device)
  allowed = ((idx[None, :] <= idx[:, None])[None]
             & ((mask[:, None, :] != 0) | (idx[None, :] == idx[:, None])[None]))
  scores = scores.masked_fill(~allowed[:, None], float("-inf"))
  ctx = torch.softmax(scores, -1) @ kv[..., nope:]
  return ctx.transpose(1, 2).reshape(n, s, nh * vd) @ p[pre + "o_proj.weight"].T


def swiglu(gate_w, up_w, down_w, x):
  return (F.silu(x @ gate_w.T) * (x @ up_w.T)) @ down_w.T


def moe(p, pre, g, x, valid, bias, chosen):
  """An MoE layer over x [T, H] with its correction bias: (out [T, H], the
  scores s, the choices it took, their loads, its route gap).  With
  ``chosen`` [T, K] (the program's) those are the choices; else its own
  top-K of s + b."""
  n, k = g["n_routed_experts"], g["num_experts_per_tok"]
  scores = torch.sigmoid(x @ p[pre + "gate.weight"].T)
  biased = scores.detach() + bias
  sel = chosen if chosen is not None else torch.topk(biased, k, -1).indices
  picked = biased.gather(1, sel)
  others = biased.scatter(1, sel, float("-inf"))
  gap = float((others.max(1).values - picked.min(1).values).clamp_min(0).max())
  w = scores.gather(1, sel)
  w = w / (w.sum(-1, keepdim=True) + 1e-20) * g["routed_scaling_factor"]
  out = swiglu(p[pre + "shared_experts.gate_proj.weight"],
               p[pre + "shared_experts.up_proj.weight"],
               p[pre + "shared_experts.down_proj.weight"], x)
  gu, down = p[pre + "experts_gate_up"], p[pre + "experts_down"]
  for slot, e in enumerate(held(g)):
    hit = sel == e
    rows = hit.any(1).nonzero().squeeze(1)
    if rows.numel():
      weight = (w * hit).sum(1)[rows, None]
      y = swiglu(gu[slot, 0::2], gu[slot, 1::2], down[slot], x[rows])
      out = out.index_add(0, rows, weight * y)
  loads = torch.zeros(n, device=x.device).scatter_add(
      0, sel.reshape(-1), valid[:, None].expand(-1, k).reshape(-1))
  return out, scores, sel, loads, gap


def balance_loss(g, scores, sel, valid, captions):
  """alpha x the mean over the captions of sum_i f_i P_i."""
  n, k = g["n_routed_experts"], g["num_experts_per_tok"]
  t = valid.numel() // captions
  mask = valid.view(captions, t, 1)
  count = mask.sum(1).clamp_min(1.0)
  probs = (scores / scores.sum(-1, keepdim=True)).view(captions, t, n)
  share = (probs * mask).sum(1) / count
  hits = torch.zeros_like(scores).scatter(1, sel, 1.0).view(captions, t, n)
  f = (hits * mask).sum(1) * (n / k) / count
  return g["aux_loss_alpha"] * (f * share).sum(1).mean()


def tower(p, g, ids, mask, biases, chosen=None, train=True):
  """ids, mask [N, S] -> {"pooled" [N, H], "aux" (the balance losses'
  sum), "chosen", "loads", "route_gap"}, the last three by MoE layer; with
  ``biases`` {layer: correction bias} and ``chosen`` {layer: [N S, K]}."""
  n, s = ids.shape
  eps = g["rms_norm_eps"]
  valid = mask.reshape(-1).float()
  x = p[f"{TOWER}.embed_tokens.weight"][ids]
  aux, taken, loads, gaps = None, {}, {}, {}
  for layer in range(g["num_hidden_layers"]):
    pre = f"{TOWER}.layers.{layer}."
    x = x + mla(p, pre + "self_attn.", g,
                rms_norm(x, p[pre + "input_layernorm.weight"], eps), mask)
    h = rms_norm(x, p[pre + "post_attention_layernorm.weight"], eps)
    if layer in biases:
      out, scores, sel, loads[layer], gaps[layer] = moe(
          p, pre + "mlp.", g, h.reshape(n * s, -1), valid, biases[layer],
          (chosen or {}).get(layer))
      taken[layer] = sel
      if train:
        term = balance_loss(g, scores, sel, valid, n)
        aux = term if aux is None else aux + term
      out = out.view(n, s, -1)
    else:
      out = swiglu(p[pre + "mlp.gate_proj.weight"], p[pre + "mlp.up_proj.weight"],
                   p[pre + "mlp.down_proj.weight"], h)
    x = x + out
  x = rms_norm(x, p[f"{TOWER}.norm.weight"], eps)
  m = mask.float()[..., None]
  return {"pooled": (x * m).sum(1) / m.sum(1).clamp_min(1.0), "aux": aux,
          "chosen": taken, "loads": loads, "route_gap": max(gaps.values(),
                                                            default=0.0)}


def embed_text(p, cfg, token_ids, drop, train, biases, chosen=None):
  """token_ids [B, K, T, 2] -> the text outputs of reference/model.py's
  heads over the tower's caption embedding, and the tower's readings."""
  mods = list(cfg["experts"])
  b, k, t, _ = token_ids.shape
  ids = token_ids[..., 0].reshape(b * k, t).long()
  mask = token_ids[..., 1].reshape(b * k, t)
  tw = tower(p, geometry(cfg), ids, mask, biases, chosen, train)
  text = tw["pooled"]
  experts = []
  for m in mods:
    h = ref_model._linear(p, f"text_GU.{m}.fc", text)
    gate = ref_model._batch_norm(p, f"text_GU.{m}.cg.batch_norm",
                                 ref_model._linear(p, f"text_GU.{m}.cg.fc", h),
                                 train)
    experts.append(ref_model.l2_normalize(h * torch.sigmoid(gate)))
  moe_in = drop(text, cfg["text_bert"]["hidden_dropout_prob"])
  logits = torch.cat([ref_model._linear(p, f"moe_fc_txt.{m}", moe_in)
                      for m in mods], 1)
  return ({"text_embds": torch.stack(experts, 1).reshape(b, k, len(mods), -1),
           "text_weights": torch.softmax(logits, 1).reshape(b, k, len(mods))},
          tw)


def biases_of(p, cfg):
  """{MoE layer: a copy of its correction bias}."""
  return {layer: p[f"{TOWER}.layers.{layer}.mlp.gate.e_score_correction_bias"]
          .clone() for layer in moe_layers(geometry(cfg))}


def train_steps(initial, cfg, batches, generator, chosen=None):
  """Train from the weights ``initial(name)`` gives (a fresh tensor a
  call) on ``batches``, one step each, dropout from ``generator``, the
  routers following ``chosen[step]`` {layer: [T, K]} where given.
  Returns train.py's readings ({"losses", "grad_norms", "change_norms",
  "outputs"}) and "route_gap" (the largest over steps and layers),
  "biases" {layer: the correction bias after the last step}, "chosen"
  [{layer: the choices}] by step."""
  opt = cfg["optimizer"]
  if opt["type"] != "Adam" or opt.get("weight_decay", 0):
    raise ValueError(f"the reference's optimizer is Adam without weight "
                     f"decay, not {opt}")
  spec = param_spec(cfg)
  names = trainable(spec)
  p = {n: initial(n) for n, _, _ in spec}
  g = geometry(cfg)
  biases = biases_of(p, cfg)
  state, losses, grad_norms, outputs, gap, taken = {}, [], None, None, 0.0, []
  for step, batch in enumerate(batches, 1):
    leaves = [p[n].requires_grad_(True) for n in names]
    drop = ref_model.Dropout(generator, True)
    text, tw = embed_text(p, cfg, batch["token_ids"], drop, True, biases,
                          chosen[step - 1] if chosen else None)
    out = {**text, **ref_model.embed_video(p, cfg, batch, drop)}
    b, k, m, d = out["text_embds"].shape
    sims = ref_model.similarity(out["text_embds"].reshape(b * k, m, d),
                                out["text_weights"].reshape(b * k, m),
                                out["vid_embds"], out["vid_weights"])
    loss = ref_model.max_margin_loss(sims.reshape(b, k, -1).mean(1),
                                     cfg["loss"]["margin"],
                                     cfg["loss"]["fix_norm"])
    if tw["aux"] is not None:
      loss = loss + tw["aux"]
    grads = dict(zip(names, torch.autograd.grad(loss, leaves)))
    for n in names:
      p[n] = p[n].detach()
    if step == 1:
      grad_norms = {n: float(t.norm()) for n, t in grads.items()}
      outputs = {key: v.detach() for key, v in out.items()}
    ref_train._adam(p, grads, state, step, opt)
    with torch.no_grad():
      for layer, load in tw["loads"].items():
        biases[layer] += BIAS_UPDATE_SPEED * torch.sign(load.mean() - load)
    gap = max(gap, tw["route_gap"])
    taken.append(tw["chosen"])
    losses.append(float(loss.detach()))
    del out, sims, loss, grads, leaves, text, tw
  change = {}
  for n in names:
    change[n] = float((p[n] - initial(n)).norm())
  return {"losses": losses, "grad_norms": grad_norms, "change_norms": change,
          "outputs": outputs, "route_gap": gap, "biases": biases,
          "chosen": taken}
