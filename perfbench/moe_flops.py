"""The yardstick's arithmetic for the moonlight caption tower
(``reference/moe_text.py``): its operations a train step, and the least
time of its grouped expert kernels from the rows they took.

Operations count a product of [m, k] by [k, n] as 2 m k n, as
``flops.py`` does; the attention's products are counted whole (the
causal mask does not halve what is computed).  The routed experts'
operations follow the rows counted on the device (each MoE layer's
``expert_rows``), not an expectation: a held expert's SwiGLU is 6 H I a
row forward (gate, up, down) and twice that backward.
"""

from __future__ import annotations

import math

from perfbench import flops
from perfbench.reference import moe_text as ref

PEAK_FLOPS, PEAK_BYTES = flops.PEAK_FLOPS["float32"], flops.PEAK_BYTES
F32 = 4


def routed_row_flops(g):
  """Forward operations of one routed row through a held expert."""
  return 6 * g["hidden_size"] * g["moe_intermediate_size"]


def tower_token_flops(g, seq):
  """Forward operations of one caption token through the tower, but the
  routed experts: every layer's latent attention (its four projections
  and its two products over ``seq`` keys), the dense layer, and each MoE
  layer's router and shared experts."""
  h, nh = g["hidden_size"], g["num_attention_heads"]
  qk = g["qk_nope_head_dim"] + g["qk_rope_head_dim"]
  vd = g["v_head_dim"]
  attn = 2 * h * (nh * qk + g["kv_lora_rank"] + g["qk_rope_head_dim"])
  attn += 2 * g["kv_lora_rank"] * nh * (g["qk_nope_head_dim"] + vd)
  attn += 2 * nh * vd * h + 2 * seq * nh * (qk + vd)
  moe = len(ref.moe_layers(g))
  dense = g["num_hidden_layers"] - moe
  shared = g["moe_intermediate_size"] * g["n_shared_experts"]
  return (g["num_hidden_layers"] * attn
          + dense * 6 * h * g["intermediate_size"]
          + moe * (6 * h * shared + 2 * h * g["n_routed_experts"]))


def heads_flops(cfg):
  """Forward operations of one caption's GEU heads and MoE weight heads
  at the tower's width."""
  h, d = ref.geometry(cfg)["hidden_size"], cfg["same_dim"]
  return len(cfg["experts"]) * (2 * h * d + 2 * d * d + 2 * h)


def train_step_flops(cfg, batch, captions=1, routed_rows=None):
  """A train step: three times the forward of the tower (at
  ``routed_rows`` rows through held experts, by default the expected
  share, T K E / n), the heads, the video tower and the similarity."""
  g = ref.geometry(cfg)
  words = cfg["max_text_words"]
  tokens = batch * captions * words
  if routed_rows is None:
    routed_rows = (tokens * g["num_experts_per_tok"] * len(ref.held(g))
                   / g["n_routed_experts"] * len(ref.moe_layers(g)))
  forward = (tokens * tower_token_flops(g, words)
             + routed_rows * routed_row_flops(g)
             + batch * captions * heads_flops(cfg)
             + batch * flops.video_flops(cfg)
             + flops.similarity_flops(cfg, batch * captions, batch))
  return 3 * forward


def grouped_calls(g, tokens, rows):
  """(operations, bytes) of each grouped kernel call of one MoE layer's
  forward and backward, ``rows`` of its ``tokens`` x K assignments going
  to held experts: the weights read (and their gradients written) once,
  each row's inputs read and outputs written once."""
  h, i, e = g["hidden_size"], g["moe_intermediate_size"], len(ref.held(g))
  w = e * h * i
  assignments = tokens * g["num_experts_per_tok"]
  return [
      (4 * rows * h * i, F32 * (rows * h + 2 * w + rows * 3 * i)),  # gate_up
      (2 * rows * i * h, F32 * (rows * i + w + rows * h)),          # down
      (0, F32 * (rows * h + tokens * h + assignments)),             # combine
      (2 * rows * h * i, F32 * (rows * h + w + rows * 2 * i      # dgate_up
                                + rows * 4 * i)),
      (4 * rows * i * h, F32 * (rows * 2 * i + 2 * w + rows * h)),  # dx
      (0, F32 * (rows * h + tokens * h + assignments)),             # combine
      (4 * rows * i * h, F32 * (rows * 2 * i + rows * h + 2 * w)),  # dW gu
      (2 * rows * h * i, F32 * (rows * h + rows * i + w)),          # dW down
  ]


def grouped_bound_s(g, tokens, rows_by_layer):
  """Least seconds of the grouped calls of a step whose MoE layers sent
  ``rows_by_layer`` rows to held experts: each call at the larger of its
  operations at the fp32 peak and its bytes at the memory rate."""
  return sum(max(ops / PEAK_FLOPS, nbytes / PEAK_BYTES)
             for rows in rows_by_layer
             for ops, nbytes in grouped_calls(g, tokens, rows))


def steps_rows(cfg, rows):
  """Rows sent to held experts by layer, from row counters [layers,
  n_experts] (the held experts' columns)."""
  held = ref.held(ref.geometry(cfg))
  return [float(r[held].sum()) for r in rows]


def held_share(cfg, rows):
  """The busiest held expert's rows over the held experts' mean, the
  largest over the MoE layers, of row counters [layers, n_experts]."""
  held = ref.held(ref.geometry(cfg))
  worst = 0.0
  for r in rows:
    r = r[held].double()
    if float(r.mean()) > 0:
      worst = max(worst, float(r.max() / r.mean()))
  return worst if worst > 0 else math.nan
