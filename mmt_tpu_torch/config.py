"""Transformer hyperparameters of the port.

The subset of mmt_tpu/config.py that the port's models read (BertParams and
the bert-base-cased text geometry), copied so that the port
imports nothing of the JAX package.  Field names and defaults are the
same; tests hold them equal.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict


@dataclasses.dataclass(frozen=True)
class BertParams:
  """Transformer hyperparameters (vid_bert_params / text-BERT geometry)."""
  hidden_size: int = 512
  num_hidden_layers: int = 4
  num_attention_heads: int = 4
  intermediate_size: int = 3072
  hidden_act: str = "gelu"
  hidden_dropout_prob: float = 0.1
  attention_probs_dropout_prob: float = 0.1
  max_position_embeddings: int = 32
  type_vocab_size: int = 19
  initializer_range: float = 0.02
  layer_norm_eps: float = 1e-12
  vocab_size: int = 0  # 0 => feature-additive model with no word table

  @classmethod
  def from_dict(cls, d: Dict[str, Any]) -> "BertParams":
    known = {f.name for f in dataclasses.fields(cls)}
    return cls(**{k: v for k, v in d.items() if k in known})


# bert-base-cased geometry, for the text side.
TEXT_BERT_BASE_CASED = BertParams(
    hidden_size=768,
    num_hidden_layers=12,
    num_attention_heads=12,
    intermediate_size=3072,
    hidden_act="gelu",
    max_position_embeddings=512,
    type_vocab_size=2,
    layer_norm_eps=1e-12,
    vocab_size=28996,
)
