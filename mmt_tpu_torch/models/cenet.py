"""CENet forward (eval and train) with the flagship switches.

Port of mmt_tpu/models/cenet.py for the MSRVTT-jsfusion flagship:
txt_agg ``bertftn`` (CLS of a bert-base-cased tower), txt_pro ``gbn``
(gated embedding units with BatchNorm), txt_wgh ``emb`` (MoE weights from
the caption embedding), vid_inp ``both``, vid_cont ``bert``, vid_wgh
``none``, pos_enc ``tint``, out_tok ``mxp``, missing modalities kept.  Any
other value of a switch raises NotImplementedError.

The video tokens are ordered [CLS, agg x M, temporal x M x L], the JAX
package's grouped order (semantically the reference's interleave: the
transformer is permutation-equivariant given type, position and mask).
Module names are the reference's state-dict names (``txt_bert``,
``vid_bert``, ``text_GU``, ``video_dim_reduce``, ``moe_fc_txt``).
"""

from __future__ import annotations

from typing import Any, Mapping, Optional

import torch
from torch import nn

from mmt_tpu_torch.config import BertParams, TEXT_BERT_BASE_CASED
from mmt_tpu_torch.models import components as C
from mmt_tpu_torch.models.bert import (FeatureBert, TextBert, init_normal_,
                                       shard_dims)
from mmt_tpu_torch.ops import similarity as similarity_ops
from mmt_tpu_torch.ops.dropout import dropout

FLAGSHIP_SWITCHES = dict(
    keep_missing_modalities=True, test_caption_mode="indep",
    txt_inp="bertftn", txt_agg="bertftn", txt_pro="gbn", txt_wgh="emb",
    vid_inp="both", vid_cont="bert", vid_wgh="none", pos_enc="tint",
    out_tok="mxp", normalize_experts=True)


class CENet(nn.Module):
  """Cross-modal video/text retrieval network, built on ``device`` (the
  card unless the caller asks for the CPU).

  With a ``tp`` (``parallel.TensorParallel``) the encoder layers of both
  towers hold this rank's tensor-parallel shards (models/bert.py); all
  else (embeddings, LayerNorms, GEU heads, BatchNorm, MoE heads) is
  replicated and computes the same on every rank.  ``shard_dims`` maps
  each split parameter to the dim it is split on.
  """

  def __init__(self, expert_dims: Mapping[str, Mapping[str, int]],
               vid_bert_params: Mapping[str, Any],
               txt_bert_params: Optional[Mapping[str, Any]] = None,
               text_bert_geometry: Optional[Mapping[str, Any]] = None,
               same_dim: int = 512, compute_dtype=torch.float32,
               device="cuda", tp=None, **switches):
    super().__init__()
    for name, value in switches.items():
      if name not in FLAGSHIP_SWITCHES:
        raise TypeError(f"unknown CENet argument {name!r}")
      if value != FLAGSHIP_SWITCHES[name]:
        raise NotImplementedError(
            f"{name}={value!r}: the port implements only the flagship "
            f"value {FLAGSHIP_SWITCHES[name]!r}")
    self.expert_dims = dict(expert_dims)
    self.modalities = list(self.expert_dims)
    self.same_dim = same_dim

    base = {f: getattr(TEXT_BERT_BASE_CASED, f)
            for f in TEXT_BERT_BASE_CASED.__dataclass_fields__}
    base.update(text_bert_geometry or {})
    base.update({k: v for k, v in (txt_bert_params or {}).items()
                 if k in base})
    txt_cfg = BertParams(**base)
    self.vid_cfg = BertParams.from_dict(dict(vid_bert_params))
    if self.vid_cfg.hidden_size != same_dim:
      raise ValueError(
          f"vid_bert hidden_size ({self.vid_cfg.hidden_size}) must equal "
          f"same_dim ({same_dim}) for the feature-additive embeddings")

    self.txt_bert = TextBert(txt_cfg, compute_dtype=compute_dtype,
                             device=device, tp=tp)
    self.vid_bert = FeatureBert(self.vid_cfg, compute_dtype=compute_dtype,
                                device=device, tp=tp)
    text_dim = txt_cfg.hidden_size
    self.text_GU = nn.ModuleDict({
        m: C.GatedEmbeddingUnit(text_dim, same_dim, device=device)
        for m in self.modalities})
    self.video_dim_reduce = nn.ModuleDict({
        m: C.ReduceDim(int(d["dim"]), same_dim, device=device)
        for m, d in self.expert_dims.items()})
    self.moe_fc_txt = nn.ModuleDict({
        m: nn.Linear(text_dim, 1, device=device) for m in self.modalities})
    # Dropout on the caption embedding before the MoE weight heads.
    self.moe_txt_dropout = float(
        (txt_bert_params or {}).get("hidden_dropout_prob", 0.1))
    # {name: dim} of the parameters split over the tensor-parallel ranks
    # (for convert.shard_state_dict / gather_state_dict); empty without tp.
    self.shard_dims = shard_dims(self)

  def init_weights(self, generator: torch.Generator):
    """Random weights from ``generator`` (BERT towers N(0, 0.02)-style,
    heads N(0, 1/fan_in))."""
    init_normal_(self.txt_bert, generator,
                 self.txt_bert.cfg.initializer_range)
    init_normal_(self.vid_bert, generator, self.vid_cfg.initializer_range)
    for heads in (self.text_GU, self.video_dim_reduce, self.moe_fc_txt):
      C.init_heads_(heads, generator)
    return self

  def forward(self, batch, *, train=False, generator=None):
    """batch: token_ids [B,K,T,2], and per-modality dicts features
    [B,L,D_m], features_t / features_ind [B,L], features_avgpool /
    features_maxpool [B,D_m] (torch tensors on one device).  Returns
    text_embds [B,K,M,D], text_weights [B,K,M], vid_embds [B,M,D] and
    vid_weights [B,M], all fp32.

    ``train=True`` runs the train forward: dropout from ``generator`` (a
    torch.Generator on the batch's device) at the configured rates, and
    BatchNorm on batch statistics, whose running buffers it updates."""
    return {**self.embed_text(batch["token_ids"], train=train,
                              generator=generator),
            **self.embed_video(batch, train=train, generator=generator)}

  def embed_text(self, token_ids, *, train=False, generator=None):
    b, k, t, _ = token_ids.shape
    m = len(self.modalities)
    flat = token_ids.reshape(b * k, t, 2)
    dev = token_ids.device
    pos_ids = torch.arange(t, device=dev)[None]
    type_ids = torch.zeros((1, t), dtype=torch.long, device=dev)
    last = self.txt_bert(flat[:, :, 0].long(), flat[:, :, 1], type_ids,
                         pos_ids, train=train, generator=generator)
    text = last[:, 0]
    stacked = C.batched_gated_embedding(
        text, [self.text_GU[mod] for mod in self.modalities], train=train)
    e = dropout(text, self.moe_txt_dropout if train else 0.0, generator)
    logits = C.batched_moe_logits(
        e, [self.moe_fc_txt[mod] for mod in self.modalities])
    text_weights = C.l1_normalize(torch.softmax(logits, 1).reshape(b, k, m))
    return {"text_embds": C.l2_normalize(stacked).reshape(b, k, m, -1),
            "text_weights": text_weights}

  def embed_video(self, batch, *, train=False, generator=None):
    mods = self.modalities
    b = batch["features_ind"][mods[0]].shape[0]
    reducers = [self.video_dim_reduce[mod] for mod in mods]
    maxp = C.batched_reduce_dim_ragged(
        [batch["features_maxpool"][mod] for mod in mods], reducers)
    temp = [C.l2_normalize(nn.functional.linear(
        batch["features"][mod].float(), r.fc.weight, r.fc.bias))
            for mod, r in zip(mods, reducers)]
    seq = self._assemble_video_sequence(batch, b, maxp, temp)
    last = self.vid_bert(*seq, train=train, generator=generator)
    experts = last[:, 1:1 + len(mods)]            # the agg tokens
    vid_weights = C.l1_normalize(
        torch.ones((b, len(mods)), device=experts.device))
    return {"vid_embds": C.l2_normalize(experts),
            "vid_weights": vid_weights}

  def _assemble_video_sequence(self, batch, b, maxp_stack, temp_feats):
    """(features, attention_mask, token_type_ids, position_ids) of the
    [CLS, agg x M, temporal x M x L] sequence."""
    mods = self.modalities
    dev = maxp_stack.device
    max_pos = self.vid_cfg.max_position_embeddings - 1
    idx = [int(self.expert_dims[mod]["idx"]) for mod in mods]
    long = dict(dtype=torch.long, device=dev)
    feats = [torch.zeros((b, 1, self.same_dim), device=dev), maxp_stack]
    types = [torch.zeros((1, 1), **long), torch.tensor([idx], **long)]
    pos = [torch.zeros((b, 1 + len(mods)), **long)]
    ind = torch.stack([batch["features_ind"][mod].amax(1) for mod in mods], 1)
    mask = [torch.ones((b, 1), **long), ind.long()]
    for mod, i, f in zip(mods, idx, temp_feats):
      feats.append(f)
      types.append(torch.full((1, f.shape[1]), i, **long))
      pos.append(batch["features_t"][mod].clamp(0, max_pos).long())
      mask.append(batch["features_ind"][mod].long())
    return (torch.cat(feats, 1), torch.cat(mask, 1), torch.cat(types, 1),
            torch.cat(pos, 1))


def similarity_from_outputs(outputs, merge: str):
  """MoE similarity from CENet outputs (caption axis unrolled)."""
  b, k, m, d = outputs["text_embds"].shape
  return similarity_ops.moe_similarity(
      outputs["text_embds"].reshape(b * k, m, d), outputs["vid_embds"],
      outputs["text_weights"].reshape(b * k, m), outputs["vid_weights"],
      merge=merge, num_caps=k)
