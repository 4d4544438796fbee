"""The yardstick's arithmetic: the model's operations per unit of work and
the least time of the FFN kernels' calls, from shapes alone.

Peaks of one NVIDIA H100 SXM at its full 700 W (NVIDIA's data sheet,
dense rates): 67 TFLOP/s in fp32 outside the tensor cores, 989 in bf16,
3.35 TB/s of device memory.  Operations count a product of [m, k] by
[k, n] as 2 m k n; lookups, norms and activations are not counted.
"""

from __future__ import annotations

PEAK_FLOPS = {"float32": 67e12, "bfloat16": 989e12}
PEAK_BYTES = 3.35e12
DTYPE_BYTES = {"float32": 4, "bfloat16": 2}


def bert_flops(tokens, seq, hidden, inter, layers):
  """Forward operations of ``layers`` BERT layers over ``tokens`` tokens
  in sequences of ``seq``: q, k, v and the output projection (8 H^2 a
  token), the FFN (4 H I) and the attention's two products (4 S H)."""
  return tokens * layers * (8 * hidden * hidden + 4 * hidden * inter
                            + 4 * seq * hidden)


def video_tokens(cfg):
  """CLS, then each expert's aggregated token and its temporal rows."""
  return 1 + len(cfg["experts"]) * (1 + cfg["max_expert_tokens"])


def caption_flops(cfg):
  """Forward operations of one caption: the text tower, then each
  expert's gated embedding unit and MoE head."""
  t, d = cfg["text_bert"], cfg["same_dim"]
  words = cfg["max_text_words"]
  h = t["hidden_size"]
  heads = len(cfg["experts"]) * (2 * h * d + 2 * d * d + 2 * h)
  return bert_flops(words, words, h, t["intermediate_size"],
                    t["num_hidden_layers"]) + heads


def video_flops(cfg):
  """Forward operations of one video: each expert's reduction of its
  pooled and temporal rows to the shared width, then the video tower."""
  v, d = cfg["vid_bert"], cfg["same_dim"]
  rows = 1 + cfg["max_expert_tokens"]
  reduce = sum(rows * 2 * e["dim"] * d for e in cfg["experts"].values())
  s = video_tokens(cfg)
  return reduce + bert_flops(s, s, v["hidden_size"], v["intermediate_size"],
                             v["num_hidden_layers"])


def similarity_flops(cfg, queries, videos):
  """The MoE similarity's numerator and denominator products."""
  return 2 * queries * videos * len(cfg["experts"]) * (cfg["same_dim"] + 1)


def train_step_flops(cfg, batch, captions=1):
  """A train step: three times the forward (forward, then the backward's
  two products per forward product), no recomputation."""
  forward = (batch * video_flops(cfg) + batch * captions * caption_flops(cfg)
             + similarity_flops(cfg, batch * captions, batch))
  return 3 * forward


def eval_flops(cfg, videos, captions=1):
  """A retrieval eval: every video and caption once, then the [Q, V]
  similarity."""
  return (videos * video_flops(cfg) + videos * captions * caption_flops(cfg)
          + similarity_flops(cfg, videos * captions, videos))


# Tensors each FFN kernel reads and writes, as (rows, cols) in units of
# R (rows), H (hidden) and I (intermediate); 1 stands for a vector.
_FFN_TENSORS = {
    # eval block B1: x, w1, b1, w2, b2, gamma, beta -> out
    "B1": ("RH", "IH", "I", "HI", "H", "H", "H", "RH"),
    # train forward B2: x, drop, w1, b1, w2, b2, gamma, beta -> out,
    # inter, z
    "B2": ("RH", "RH", "IH", "I", "HI", "H", "H", "H", "RH", "RI", "RH"),
    # train backward B3: dy, z, inter, drop, w1, w2, gamma -> dx, dz,
    # dinter
    "B3": ("RH", "RH", "RI", "RH", "IH", "HI", "H", "RH", "RH", "RI"),
}


def ffn_bound_s(kernel, rows, hidden, inter, dtype="float32"):
  """Least seconds of one FFN kernel call (copied from chip_smoke.py's
  ``bound``): the larger of its operations (the block's two products,
  4 R H I; B3's two input-gradient products likewise) at the peak and
  its bytes, each tensor read or written once, at the memory rate."""
  size = {"R": rows, "H": hidden, "I": inter}
  elems = 0
  for shape in _FFN_TENSORS[kernel]:
    n = 1
    for c in shape:
      n *= size[c]
    elems += n
  ops_s = 4 * rows * hidden * inter / PEAK_FLOPS[dtype]
  return max(ops_s, elems * DTYPE_BYTES[dtype] / PEAK_BYTES)


def ffn_calls_train_step(cfg, batch, captions=1):
  """(kernel, R, H, I) of every FFN call of a train step: B2 forward and
  B3 backward in each layer of both towers."""
  t, v = cfg["text_bert"], cfg["vid_bert"]
  towers = ((batch * captions * cfg["max_text_words"], t),
            (batch * video_tokens(cfg), v))
  return [(k, rows, b["hidden_size"], b["intermediate_size"])
          for rows, b in towers for _ in range(b["num_hidden_layers"])
          for k in ("B2", "B3")]


def ffn_calls_eval(cfg, chunks, captions=1):
  """(kernel, R, H, I) of every FFN call of an eval over chunks of the
  given video counts: B1 in each layer of both towers, chunk by chunk."""
  t, v = cfg["text_bert"], cfg["vid_bert"]
  calls = []
  for c in chunks:
    for rows, b in ((c * captions * cfg["max_text_words"], t),
                    (c * video_tokens(cfg), v)):
      calls += [("B1", rows, b["hidden_size"], b["intermediate_size"])
                ] * b["num_hidden_layers"]
  return calls


def ffn_bound_total_s(calls, dtype="float32"):
  return sum(ffn_bound_s(*call, dtype=dtype) for call in calls)
