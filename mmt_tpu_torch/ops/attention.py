"""Multi-head attention core in plain PyTorch.

Port of mmt_tpu/ops/attention.py:attention_bhsd.  Attention was never a
TPU kernel (the JAX package leaves it to XLA), so plain torch ops are its
port: fp32 scores with a 1/sqrt(dh) scale, the additive -10000 mask bias,
an fp32 softmax, probabilities rounded to the value dtype, fp32 context.
"""

from __future__ import annotations

import math

import torch


def attention_bhsd(qh, kh, vh, *, attn_bias):
  """q/k/v [B, H, S, dh] -> fp32 ctx [B, H, S, dh].

  attn_bias: [B, 1, 1, S] additive bias.  Products of compute-dtype
  operands are taken in fp32, as the JAX path's
  ``preferred_element_type=float32`` does.
  """
  scores = qh.float() @ kh.float().transpose(-1, -2)
  scores = scores / math.sqrt(qh.shape[-1]) + attn_bias.float()
  probs = torch.softmax(scores, dim=-1).to(vh.dtype)
  return probs.float() @ vh.float()
