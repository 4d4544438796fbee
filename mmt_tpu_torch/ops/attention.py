"""Multi-head attention core in plain PyTorch.

Port of mmt_tpu/ops/attention.py:attention_bhsd.  Attention was never a
TPU kernel (the JAX package leaves it to XLA), so plain torch ops are its
port: fp32 scores with a 1/sqrt(dh) scale, the additive -10000 mask bias,
an fp32 softmax, in train mode dropout on the fp32 probabilities,
probabilities rounded to the value dtype, fp32 context.
"""

from __future__ import annotations

import math

import torch

from mmt_tpu_torch.ops.dropout import dropout


def attention_bhsd(qh, kh, vh, *, attn_bias, dropout_p=0.0, generator=None,
                   heads=None):
  """q/k/v [B, H, S, dh] -> fp32 ctx [B, H, S, dh].

  attn_bias: [B, 1, 1, S] additive bias.  Products of compute-dtype
  operands are taken in fp32, as the JAX path's
  ``preferred_element_type=float32`` does.  ``dropout_p`` > 0 (train
  mode) drops probabilities with a mask from ``generator``, as JAX does:
  where(keep, probs / (1-p), 0) in fp32, before the cast to the value
  dtype.  ``heads=(first, total)``: these H are heads [first, first + H)
  of ``total`` (a tensor-parallel rank's), and the dropout mask is drawn
  for all ``total`` and sliced (``dropout``'s ``part``).
  """
  scores = qh.float() @ kh.float().transpose(-1, -2)
  scores = scores / math.sqrt(qh.shape[-1]) + attn_bias.float()
  probs = torch.softmax(scores, dim=-1)
  part = None if heads is None else (1, *heads)
  probs = dropout(probs, dropout_p, generator, part=part).to(vh.dtype)
  return probs.float() @ vh.float()
