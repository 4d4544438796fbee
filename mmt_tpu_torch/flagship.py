"""The flagship MSRVTT-jsfusion CENet and a synthetic batch of its shapes.

Port of __graft_entry__.py:_flagship_model_and_batch: 7 experts, a 4-layer
512-wide video BERT (218 tokens: CLS + 7 x (agg + 30)), the 12-layer
bert-base-cased text tower over 30 tokens, GEU heads with BatchNorm and
MoE weights.  ``tiny=True`` gives the same structure at test widths.  The
batch recipe (numpy, seeded) is the JAX entry's, so both packages can be
fed the same inputs.
"""

from __future__ import annotations

import numpy as np
import torch

from mmt_tpu_torch import convert
from mmt_tpu_torch.experts import compute_dims
from mmt_tpu_torch.models.cenet import CENet

MODALITIES = ["face", "ocr", "rgb", "s3d", "scene", "speech", "vggish"]
TEXT_VOCAB = 28996
MAX_POSITION_EMBEDDINGS = 32   # video BERT position table (tint ids < 31)


def flagship_arch(tiny=False):
  """CENet constructor kwargs of the flagship geometry (configs/eccv20/
  msrvtt_jsfusion_trainval.json), or of its tiny test-width copy."""
  expert_dims = compute_dims({"experts": {"face_dim": 512,
                                          "modalities": MODALITIES}})
  vid = dict(hidden_size=512, num_hidden_layers=4, num_attention_heads=4,
             intermediate_size=3072, hidden_act="gelu",
             hidden_dropout_prob=0.1, attention_probs_dropout_prob=0.1,
             max_position_embeddings=MAX_POSITION_EMBEDDINGS,
             type_vocab_size=19, initializer_range=0.02,
             layer_norm_eps=1e-12)
  text_geom, same_dim = None, 512
  if tiny:
    vid.update(hidden_size=64, num_hidden_layers=2, intermediate_size=128)
    text_geom = dict(hidden_size=64, num_hidden_layers=2,
                     num_attention_heads=4, intermediate_size=128,
                     vocab_size=512, max_position_embeddings=64)
    same_dim = 64
  return dict(expert_dims=expert_dims, vid_bert_params=vid,
              text_bert_geometry=text_geom, same_dim=same_dim,
              txt_bert_params={"hidden_dropout_prob": 0.1,
                               "attention_probs_dropout_prob": 0.1})


def flagship_model(*, device, compute_dtype=torch.bfloat16, seed=0,
                   tiny=False, train=False, tp=None):
  """The flagship CENet on ``device`` with random weights from ``seed``,
  in eval mode (``train=True``: in train mode, for ``train.step``).

  With a ``tp`` (``parallel.TensorParallel``) the whole model is made
  from the seed and this rank keeps its shards: the single-device model,
  split.
  """
  arch = flagship_arch(tiny=tiny)
  model = CENet(**arch, compute_dtype=compute_dtype, device=device)
  gen = torch.Generator(device=device).manual_seed(seed)
  model.init_weights(gen)
  if tp is not None:
    full = model.state_dict()
    model = CENet(**arch, compute_dtype=compute_dtype, device=device, tp=tp)
    model.load_state_dict(convert.shard_state_dict(full, tp,
                                                   model.shard_dims))
  return model.train(train)


def make_batch(expert_dims, batch_size, *, max_expert_tokens=30,
               max_text_words=30, vocab=TEXT_VOCAB, seed=0):
  """Numpy batch of the flagship's input shapes (the JAX entry's recipe):
  token_ids [B,1,T,2], per-expert features [B,L,dim], features_t /
  features_ind [B,L], avgpool / maxpool [B,dim]."""
  rng = np.random.RandomState(seed)
  b, t, l = batch_size, max_text_words, max_expert_tokens
  return {
      "token_ids": np.stack([rng.randint(0, vocab, (b, 1, t)),
                             np.ones((b, 1, t))], -1).astype(np.int32),
      "query_masks": np.ones((b, 1), np.float32),
      "features": {m: rng.randn(b, l, d["dim"]).astype(np.float32)
                   for m, d in expert_dims.items()},
      "features_t": {m: rng.randint(0, MAX_POSITION_EMBEDDINGS - 1,
                                    (b, l)).astype(np.float32)
                     for m in expert_dims},
      "features_ind": {m: np.ones((b, l), np.float32) for m in expert_dims},
      "features_avgpool": {m: rng.randn(b, d["dim"]).astype(np.float32)
                           for m, d in expert_dims.items()},
      "features_maxpool": {m: rng.randn(b, d["dim"]).astype(np.float32)
                           for m, d in expert_dims.items()},
  }


def batch_to_torch(batch, device):
  """Numpy batch (nested dicts) -> torch tensors on ``device``."""
  return {k: (batch_to_torch(v, device) if isinstance(v, dict)
              else torch.as_tensor(v, device=device))
          for k, v in batch.items()}
