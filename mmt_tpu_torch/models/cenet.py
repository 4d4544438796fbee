"""CENet forward (eval and train) with every config switch.

Port of mmt_tpu/models/cenet.py:

* ``txt_agg``: bert{ftn,frz,scr}[N]{cls,mxp,mnp} (a BERT text tower and
  its CLS, max or mean over the tokens after the CLS) | vlad | mxp | lstm
  (the word-embedding path: ``TxtEmbeddings``, then ``NetVLAD``, a masked
  max or ``LSTMPooler``) | moonlight (Moonlight-16B-A3B's MLA and
  routed-expert decoder over ``text_tower``'s geometry, models/moe_text.py,
  read as the mean of its valid tokens; it adds its balance loss to the
  train forward's outputs as ``aux_loss``, and ``post_step`` updates its
  routers' correction biases after each optimizer step);
* ``txt_pro``: gbn | gem (gated embedding units with / without BatchNorm)
  | lin (a ReduceDim);
* ``txt_wgh`` / ``vid_wgh``: emb (MoE weights from the caption / the
  video CLS) | nrm (video only: the experts' norms) | none;
* ``vid_cont``: bert (the video transformer) | coll (collaborative
  gating) | none;
* ``vid_inp``: agg | both | all | temp; ``pos_enc``: tint | ordr | type |
  none; ``out_tok``: sep | mxp | mnp;
* ``keep_missing_modalities``, ``normalize_experts``, and the
  reference's inert knobs (stored, unused, as in the JAX package).

An unknown switch value raises ValueError (an unknown ``txt_agg`` fails
the config parser's check, in both packages); so do the JAX package's two
config errors (``vid_wgh='emb'`` without the video transformer,
``vid_inp='temp'`` with it).  ``cenet_kwargs_from_arch_args`` turns an
experiment's ``arch.args`` into constructor arguments.

The video tokens are ordered [CLS, agg x M, temporal x M x L], the JAX
package's grouped order (semantically the reference's interleave: the
transformer is permutation-equivariant given type, position and mask).
Module names are the reference's state-dict names (``txt_bert``,
``vid_bert``, ``text_GU``, ``video_dim_reduce``, ``moe_fc_txt``,
``moe_fc_vid``, ``video_GU``, ``g_reason_1`` ..., ``word_embeddings``,
``text_pooling``).
"""

from __future__ import annotations

import logging
import os
from typing import Any, Mapping, Optional

import torch
from torch import nn

from mmt_tpu_torch import convert
from mmt_tpu_torch.config import BertParams, TEXT_BERT_BASE_CASED, TxtAggSpec
from mmt_tpu_torch.models import components as C
from mmt_tpu_torch.models import moe_text
from mmt_tpu_torch.models.bert import (FeatureBert, TextBert, init_normal_,
                                       shard_dims)
from mmt_tpu_torch.ops import similarity as similarity_ops
from mmt_tpu_torch.ops.dropout import dropout
from mmt_tpu_torch.parallel.mesh import row_part
from mmt_tpu_torch.utils.timing import span

logger = logging.getLogger(__name__)

# Config value of ``compute_dtype`` -> torch dtype.
COMPUTE_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}

# The switches' values (the first is the default, the flagship's).
SWITCHES = dict(
    txt_pro=("gbn", "gem", "lin"), txt_wgh=("emb", "none"),
    vid_inp=("both", "agg", "all", "temp"), vid_cont=("bert", "coll", "none"),
    vid_wgh=("none", "emb", "nrm"), pos_enc=("tint", "ordr", "type", "none"),
    out_tok=("mxp", "sep", "mnp"))
# Video inputs that carry the aggregated / the temporal tokens.
AGG_INPUTS, TEMP_INPUTS = ("agg", "both", "all"), ("temp", "both", "all")
# The reference's knobs that change nothing (mmt_tpu/models/cenet.py:
# 107-118); stored so reference configs load unmodified.
INERT_KNOBS = dict(test_caption_mode="indep", txt_inp="bertftn",
                   l2renorm=False, freeze_weights=False, mimic_ce_dims=False,
                   concat_experts=False, concat_mix_experts=False,
                   use_experts="origfeat", use_mask="nomask", agg_dims=None)
# Widths of the word-embedding poolers (fixed in the JAX package).
VLAD_CLUSTERS, LSTM_DIM = 28, 512


def cenet_kwargs_from_arch_args(arch_args, tokenizer):
  """CENet constructor kwargs from an experiment's ``arch.args``.

  Port of mmt_tpu/models/cenet.py:cenet_kwargs_from_arch_args, the one
  place where config-surface knobs become constructor arguments:

  * reference-inert keys dropped (``vocab_size``);
  * ``txt_bert_init`` extracted and RETURNED (training-only knob, not a
    CENet argument);
  * ``compute_dtype`` string -> torch dtype (COMPUTE_DTYPES);
  * text vocab sizing from the tokenizer: the bert tower gets
    ``text_bert_geometry.vocab_size`` when a custom geometry names one or
    MMT_TPU_BERT_VOCAB is set; the word-embedding path gets
    ``we_vocab_size`` / ``we_dim`` from the word vectors.

  Returns ``(kwargs, txt_bert_init_path_or_None)``.
  """
  kwargs = {k: v for k, v in dict(arch_args).items()
            if k not in ("vocab_size",)}
  txt_bert_init = kwargs.pop("txt_bert_init", None)
  if "compute_dtype" in kwargs:
    name = kwargs["compute_dtype"]
    if name not in COMPUTE_DTYPES:
      raise ValueError(f"compute_dtype {name!r}: expected one of "
                       f"{sorted(COMPUTE_DTYPES)}")
    kwargs["compute_dtype"] = COMPUTE_DTYPES[name]
  txt_agg = dict(arch_args).get("txt_agg", "bert")
  if (tokenizer is not None and hasattr(tokenizer, "vocab_size")
      and txt_agg != moe_text.KIND):
    geom = dict(kwargs.get("text_bert_geometry") or {})
    if txt_agg[:4] != "bert":
      kwargs.setdefault("we_vocab_size", tokenizer.vocab_size)
      if hasattr(tokenizer, "text_dim"):
        kwargs.setdefault("we_dim", tokenizer.text_dim)
    elif "vocab_size" in geom or os.environ.get("MMT_TPU_BERT_VOCAB"):
      geom.setdefault("vocab_size", tokenizer.vocab_size)
      kwargs["text_bert_geometry"] = geom
  return kwargs, txt_bert_init


class CENet(nn.Module):
  """Cross-modal video/text retrieval network, built on ``device`` (the
  card unless the caller asks for the CPU).

  With a ``tp`` (``parallel.TensorParallel``) the encoder layers of both
  towers hold this rank's tensor-parallel shards (models/bert.py); all
  else (embeddings, LayerNorms, GEU heads, BatchNorm, MoE heads) is
  replicated and computes the same on every rank.  ``shard_dims`` maps
  each split parameter to the dim it is split on.  Every switch acts
  outside the encoder layers, on replicated modules, so each runs under
  tensor parallelism: a config with one BERT tower (``vid_cont`` coll or
  none, or a word-vector text path) splits that tower alone, one with
  none replicates everything.

  The train forward takes a ``dp`` (``parallel.DataParallel``) when the
  batch is this rank's rows of a global batch: every dropout mask is
  drawn at the global batch's shape and sliced to the rank's rows, and
  every train-mode BatchNorm takes the global batch's moments, so the
  rank computes its rows of the single-device forward.
  """

  def __init__(self, expert_dims: Mapping[str, Mapping[str, int]],
               vid_bert_params: Mapping[str, Any],
               txt_bert_params: Optional[Mapping[str, Any]] = None,
               text_bert_geometry: Optional[Mapping[str, Any]] = None,
               same_dim: int = 512, compute_dtype=torch.float32,
               device="cuda", tp=None, txt_agg: str = "bertftn",
               keep_missing_modalities: bool = True,
               normalize_experts: bool = True, we_vocab_size: int = 0,
               we_dim: int = 768, text_tower: Optional[Mapping[str, Any]] = None,
               **switches):
    super().__init__()
    for name, value in switches.items():
      if name in SWITCHES:
        if value not in SWITCHES[name]:
          raise ValueError(f"unknown {name} {value!r}: expected one of "
                           f"{SWITCHES[name]}")
      elif name not in INERT_KNOBS:
        raise TypeError(f"unknown CENet argument {name!r}")
    for name, values in SWITCHES.items():
      setattr(self, name, switches.get(name, values[0]))
    for name, default in INERT_KNOBS.items():
      setattr(self, name, switches.get(name, default))
    self.txt_agg, self.txt_agg_spec = txt_agg, TxtAggSpec.parse(txt_agg)
    self.keep_missing_modalities = keep_missing_modalities
    self.normalize_experts = normalize_experts
    # The constructor's arguments but the device and tp: init_weights
    # builds the single-device model from them under tensor parallelism.
    self._arch = dict(
        expert_dims=expert_dims, vid_bert_params=vid_bert_params,
        txt_bert_params=txt_bert_params,
        text_bert_geometry=text_bert_geometry, same_dim=same_dim,
        compute_dtype=compute_dtype, txt_agg=txt_agg,
        keep_missing_modalities=keep_missing_modalities,
        normalize_experts=normalize_experts, we_vocab_size=we_vocab_size,
        we_dim=we_dim, text_tower=text_tower, **switches)
    self.tp = tp if tp is not None and tp.size > 1 else None
    self.expert_dims = dict(expert_dims)
    self.modalities = list(self.expert_dims)
    self.same_dim = same_dim
    mods, dev = self.modalities, device
    self.vid_cfg = BertParams.from_dict(dict(vid_bert_params))
    vid_drop = float(dict(vid_bert_params).get("hidden_dropout_prob", 0.1))
    # Dropout on the caption embedding before the MoE weight heads.
    self.moe_txt_dropout = float(
        (txt_bert_params or {}).get("hidden_dropout_prob", 0.1))

    # --- text encoder ---
    if self.txt_agg_spec.kind == "bert":
      base = {f: getattr(TEXT_BERT_BASE_CASED, f)
              for f in TEXT_BERT_BASE_CASED.__dataclass_fields__}
      base.update(text_bert_geometry or {})
      base.update({k: v for k, v in (txt_bert_params or {}).items()
                   if k in base})
      txt_cfg = BertParams(**base)
      self.txt_bert = TextBert(txt_cfg, compute_dtype=compute_dtype,
                               device=dev, tp=tp)
      text_dim = txt_cfg.hidden_size
    elif self.txt_agg_spec.kind == moe_text.KIND:
      if self.tp is not None:
        raise ValueError(f"txt_agg {txt_agg!r}: the {moe_text.KIND} tower "
                         "runs on one device; it refuses tensor parallelism")
      self.txt_tower = moe_text.MoETextTower(
          moe_text.TowerConfig.from_dict(text_tower or {}), device=dev)
      text_dim = self.txt_tower.cfg.hidden_size
    else:
      if we_vocab_size <= 0:
        raise ValueError("the word-embedding text path (txt_agg "
                         f"{txt_agg!r}) needs we_vocab_size")
      self.word_embeddings = C.TxtEmbeddings(we_vocab_size, we_dim,
                                             device=dev)
      if txt_agg == "vlad":
        self.text_pooling = C.NetVLAD(VLAD_CLUSTERS, we_dim, device=dev)
        text_dim = self.text_pooling.out_dim
      elif txt_agg == "lstm":
        self.text_pooling = C.LSTMPooler(we_dim, LSTM_DIM, LSTM_DIM,
                                         device=dev)
        text_dim = LSTM_DIM
      else:  # mxp / mnp
        text_dim = we_dim
    self.text_dim = text_dim

    # --- per-modality text heads ---
    if self.txt_pro == "lin":
      self.text_GU = nn.ModuleDict({
          m: C.ReduceDim(text_dim, same_dim, device=dev) for m in mods})
    else:
      self.text_GU = nn.ModuleDict({
          m: C.GatedEmbeddingUnit(text_dim, same_dim,
                                  use_bn=self.txt_pro == "gbn", device=dev)
          for m in mods})

    # --- video side ---
    self.video_dim_reduce = nn.ModuleDict({
        m: C.ReduceDim(int(d["dim"]), same_dim, device=dev)
        for m, d in self.expert_dims.items()})
    if self.vid_cont == "bert":
      if self.vid_cfg.hidden_size != same_dim:
        raise ValueError(
            f"vid_bert hidden_size ({self.vid_cfg.hidden_size}) must equal "
            f"same_dim ({same_dim}) for the feature-additive embeddings")
      outside = {m: int(d["idx"]) for m, d in self.expert_dims.items()
                 if not 0 <= int(d["idx"]) < self.vid_cfg.type_vocab_size}
      if outside:
        # flax's nn.Embed gives NaN rows for such an index (ROADMAP C8);
        # torch's lookup would fail inside a kernel.
        raise ValueError(
            f"expert token-type indices {outside} lie outside the video "
            f"tower's type_vocab_size ({self.vid_cfg.type_vocab_size}): "
            "register the expert with an idx below it, or raise "
            "vid_bert_params.type_vocab_size")
      self.vid_bert = FeatureBert(self.vid_cfg, compute_dtype=compute_dtype,
                                  device=dev, tp=tp,
                                  positions=self.pos_enc != "none")
      # The aggregated tokens' type ids [1, M], kept on the device: a list
      # made into a device tensor in the forward is a copy from pageable
      # host memory, which synchronises (and cannot be captured).
      self.register_buffer("agg_type_ids", torch.tensor(
          [[int(self.expert_dims[m]["idx"]) for m in mods]],
          dtype=torch.long, device=dev), persistent=False)
    elif self.vid_cont == "coll":
      if len(mods) < 2:
        raise ValueError("vid_cont 'coll' needs more than one modality")
      for name, width in (("g_reason_1", 2 * same_dim),
                          ("g_reason_2", same_dim), ("f_reason_1", same_dim),
                          ("f_reason_2", same_dim)):
        setattr(self, name, nn.Linear(width, same_dim, device=dev))
      self.video_GU = nn.ModuleDict({
          m: C.GatedEmbeddingUnitReasoning(same_dim, device=dev)
          for m in mods})
      self.coll_dropout = vid_drop
      # The ordered pairs (i, j), j != i, of modalities [2, M (M - 1)], on
      # the device for the same reason as ``agg_type_ids``.
      pairs = [(i, j) for i in range(len(mods)) for j in range(len(mods))
               if j != i]
      self.register_buffer("coll_pairs", torch.tensor(
          list(zip(*pairs)), dtype=torch.long, device=dev), persistent=False)
    if self.vid_wgh == "emb" and self.vid_cont != "bert":
      # The video MoE-weight head reads the CLS embedding, which only the
      # transformer path produces.
      raise ValueError("vid_wgh='emb' requires vid_cont='bert'")

    # --- MoE weight heads ---
    if self.txt_wgh == "emb":
      self.moe_fc_txt = nn.ModuleDict({
          m: nn.Linear(text_dim, 1, device=dev) for m in mods})
    if self.vid_wgh == "emb":
      self.moe_fc_vid = nn.ModuleDict({
          m: nn.Linear(same_dim, 1, device=dev) for m in mods})
      self.moe_vid_dropout = vid_drop
    # {name: dim} of the parameters split over the tensor-parallel ranks
    # (for convert.shard_state_dict / gather_state_dict); empty without tp.
    self.shard_dims = shard_dims(self)
    if self.tp is not None and not self.shard_dims:
      logger.info("tensor parallelism: no BERT tower (txt_agg %s, vid_cont "
                  "%s) to split; every parameter is replicated on the %d "
                  "ranks", txt_agg, self.vid_cont, self.tp.size)

  def video_seq_len(self, max_expert_tokens: int) -> int:
    """Tokens of the video sequence [CLS, agg x M, temporal x M x L] at
    L = ``max_expert_tokens`` (mmt_tpu/models/cenet.py:CENet.
    video_seq_len): 1 + M under vid_inp 'agg', 1 + M L under 'temp' and
    1 + M (1 + L) under 'both' and 'all'."""
    per_expert = (int(self.vid_inp in AGG_INPUTS)
                  + int(self.vid_inp in TEMP_INPUTS) * max_expert_tokens)
    return 1 + len(self.modalities) * per_expert

  def init_weights(self, generator: torch.Generator):
    """Random weights from ``generator`` (BERT towers N(0, 0.02)-style,
    heads N(0, 1/fan_in), the word table N(0, 0.02), the NetVLAD clusters
    N(0, 1/sqrt(D))).  Under tensor parallelism the single-device model
    draws them (the same draws, in the same order) and this rank keeps
    its shards."""
    if self.tp is not None:
      device = next(self.parameters()).device
      full = CENet(**self._arch, device=device).init_weights(generator)
      self.load_state_dict(convert.shard_state_dict(
          full.state_dict(), self.tp, self.shard_dims), strict=True)
      return self
    if hasattr(self, "txt_bert"):
      init_normal_(self.txt_bert, generator,
                   self.txt_bert.cfg.initializer_range)
    if hasattr(self, "txt_tower"):
      self.txt_tower.init_weights(generator)
    if hasattr(self, "vid_bert"):
      init_normal_(self.vid_bert, generator, self.vid_cfg.initializer_range)
    for name in ("text_GU", "video_dim_reduce", "moe_fc_txt", "moe_fc_vid",
                 "g_reason_1", "g_reason_2", "f_reason_1", "f_reason_2",
                 "video_GU"):
      if hasattr(self, name):
        C.init_heads_(getattr(self, name), generator)
    if hasattr(self, "word_embeddings"):
      init_normal_(self.word_embeddings, generator, 0.02)
    if hasattr(self, "text_pooling"):
      C.init_heads_(self.text_pooling, generator)
      self.text_pooling.init_weights(generator)
    return self

  def forward(self, batch, *, train=False, generator=None, dp=None):
    """batch: token_ids [B,K,T,2], and per-modality dicts features
    [B,L,D_m], features_t / features_ind [B,L], features_avgpool /
    features_maxpool [B,D_m] (torch tensors on one device).  Returns
    text_embds [B,K,M,D], text_weights [B,K,M], vid_embds [B,M,D] and
    vid_weights [B,M], all fp32.

    ``train=True`` runs the train forward: dropout from ``generator`` (a
    torch.Generator on the batch's device) at the configured rates, and
    BatchNorm on batch statistics, whose running buffers it updates;
    ``dp`` makes both the global batch's (see the class).  The
    moonlight tower's train forward also returns its balance loss,
    ``aux_loss``, which the step adds to the loss."""
    return {**self.embed_text(batch["token_ids"], train=train,
                              generator=generator, dp=dp),
            **self.embed_video(batch, train=train, generator=generator,
                               dp=dp)}

  # ------------------------------------------------------------------
  def post_step(self):
    """After an optimizer step: the moonlight tower's routers' correction
    biases move by the step's loads (a no-op for every other tower)."""
    if hasattr(self, "txt_tower"):
      self.txt_tower.update_biases()

  def _pooled_text(self, ids, mask, train, generator, dp):
    """The caption embedding [B*K, text_dim] of ids / mask [B*K, T]."""
    spec = self.txt_agg_spec
    if spec.kind == "bert":
      t, dev = ids.shape[1], ids.device
      pos_ids = torch.arange(t, device=dev)[None]
      type_ids = torch.zeros((1, t), dtype=torch.long, device=dev)
      last = self.txt_bert(ids, mask, type_ids, pos_ids, train=train,
                           generator=generator, dp=dp)
      if spec.post_agg == "cls":
        return last[:, 0]
      if spec.post_agg == "mxp":
        return last[:, 1:].amax(1)
      return last[:, 1:].mean(1)
    words = self.word_embeddings(ids)
    if self.txt_agg == "mxp":
      low = torch.finfo(words.dtype).min
      return words.masked_fill((mask == 0)[..., None], low).amax(1)
    if self.txt_agg == "vlad":
      return self.text_pooling(words, train=train, dp=dp)
    if self.txt_agg == "lstm":
      return self.text_pooling(words, mask.sum(1))
    raise ValueError(f"unknown txt_agg {self.txt_agg!r}")

  def embed_text(self, token_ids, *, train=False, generator=None, dp=None):
    """Caption tower only: token_ids [B,K,T,2] -> {text_embds [B,K,M,D],
    text_weights [B,K,M]} (the serving path's query embedding)."""
    with span("mmt.tower.text"):
      b, k, t, _ = token_ids.shape
      m = len(self.modalities)
      flat = token_ids.reshape(b * k, t, 2)
      ids, mask, aux = flat[:, :, 0].long(), flat[:, :, 1], None
      if hasattr(self, "txt_tower"):
        if dp is not None:
          raise ValueError(f"the {moe_text.KIND} tower runs on one device; "
                           "it refuses data parallelism")
        text, aux = self.txt_tower(ids, mask, train=train)
      else:
        text = self._pooled_text(ids, mask, train, generator, dp)
      heads = [self.text_GU[mod] for mod in self.modalities]
      if self.txt_pro == "lin":
        stacked = C.batched_reduce_dim(text, heads)
      else:
        stacked = C.batched_gated_embedding(
            text, heads, train=train, use_bn=self.txt_pro == "gbn",
            normalize=self.normalize_experts, dp=dp)
      if self.txt_wgh == "emb":
        e = dropout(text, self.moe_txt_dropout if train else 0.0, generator,
                    part=row_part(dp, text))
        logits = C.batched_moe_logits(
            e, [self.moe_fc_txt[mod] for mod in self.modalities])
        text_weights = torch.softmax(logits, 1).reshape(b, k, m)
      else:
        text_weights = torch.ones((b, k, m), device=text.device)
      if self.normalize_experts:
        stacked = C.l2_normalize(stacked)
      out = {"text_embds": stacked.reshape(b, k, m, -1).float(),
             "text_weights": C.l1_normalize(text_weights)}
      if train and aux is not None:
        out["aux_loss"] = aux
      return out

  def embed_video(self, batch, *, train=False, generator=None, dp=None):
    """Video tower only: expert-feature batch -> {vid_embds [B,M,D],
    vid_weights [B,M]} (index building, and the video half of the
    forward)."""
    with span("mmt.tower.video"):
      mods = self.modalities
      b = batch["features_ind"][mods[0]].shape[0]
      ind = torch.stack([batch["features_ind"][mod].amax(1) for mod in mods],
                        1)                                      # [B, M]
      reducers = [self.video_dim_reduce[mod] for mod in mods]
      pooled = lambda key: C.batched_reduce_dim_ragged(
          [batch[key][mod] for mod in mods], reducers)
      vid_embd = None
      if self.vid_inp not in AGG_INPUTS:
        if self.vid_cont == "bert":
          raise ValueError(
              "vid_inp='temp' with vid_cont='bert' has no aggregated token "
              "to read the expert embedding from; use 'both' or 'all'")
        raise ValueError(f"vid_inp='temp' with vid_cont={self.vid_cont!r} "
                         "has no pooled expert embedding")
      if self.vid_cont == "bert":
        agg = {"sep": None, "mxp": "features_maxpool",
               "mnp": "features_avgpool"}[self.out_tok]
        agg = (torch.zeros((b, len(mods), self.same_dim), device=ind.device)
               if agg is None else pooled(agg))
        temp = [C.l2_normalize(nn.functional.linear(
            batch["features"][mod].float(), r.fc.weight, r.fc.bias))
                for mod, r in zip(mods, reducers)
                if self.vid_inp in TEMP_INPUTS]
        seq = self._assemble_video_sequence(batch, b, agg, temp)
        last = self.vid_bert(*seq, train=train, generator=generator, dp=dp)
        vid_embd = last[:, 0]
        experts = last[:, 1:1 + len(mods)]                      # agg tokens
      else:
        experts = pooled("features_maxpool")
        if self.vid_cont == "coll":
          experts = self._collaborative_gating(experts, ind, train, generator,
                                               dp)

      if self.vid_wgh == "nrm":
        norms = C.safe_norm(experts)                            # [B, M]
        vid_weights = norms / norms.sum(-1, keepdim=True)
      elif self.vid_wgh == "emb":
        e = dropout(vid_embd, self.moe_vid_dropout if train else 0.0,
                    generator, part=row_part(dp, vid_embd))
        logits = C.batched_moe_logits(
            e.float(), [self.moe_fc_vid[mod] for mod in mods])
        vid_weights = torch.softmax(logits, 1)
      else:
        vid_weights = torch.ones((b, len(mods)), device=experts.device)
      if not self.keep_missing_modalities:
        vid_weights = vid_weights * ind.float()
      if self.normalize_experts:
        experts = C.l2_normalize(experts)
      return {"vid_embds": experts.float(),
              "vid_weights": C.l1_normalize(vid_weights)}

  def _assemble_video_sequence(self, batch, b, agg_stack, temp_feats):
    """(features, attention_mask, token_type_ids, position_ids) of the
    [CLS, agg x M, temporal x M x L] sequence from the aggregated tokens
    [B, M, D] and each modality's temporal projections [B, L, D] (none
    for vid_inp 'agg'); position_ids None under pos_enc 'none'."""
    mods = self.modalities
    dev = agg_stack.device
    max_pos = self.vid_cfg.max_position_embeddings - 1
    idx = [int(self.expert_dims[mod]["idx"]) for mod in mods]
    long = dict(dtype=torch.long, device=dev)
    tint = self.pos_enc == "tint"
    feats = [torch.zeros((b, 1, self.same_dim), device=dev), agg_stack]
    types = [torch.zeros((1, 1), **long), self.agg_type_ids]
    pos = [torch.zeros((b if tint else 1, 1 + len(mods)), **long)]
    ind = torch.stack([batch["features_ind"][mod].amax(1) for mod in mods], 1)
    mask = [torch.ones((b, 1), **long), ind.long()]
    for mod, i, f in zip(mods, idx, temp_feats):
      n = f.shape[1]
      feats.append(f)
      types.append(torch.full((1, n), i, **long))
      if tint:
        pos.append(batch["features_t"][mod].clamp(0, max_pos).long())
      elif self.pos_enc == "ordr":
        pos.append(torch.arange(1, n + 1, **long)[None])
      else:  # type: ones; none: no position embedding at all
        pos.append(torch.full((1, n), int(self.pos_enc == "type"), **long))
      mask.append(batch["features_ind"][mod].long())
    return (torch.cat(feats, 1), torch.cat(mask, 1), torch.cat(types, 1),
            None if self.pos_enc == "none" else torch.cat(pos, 1))

  def _collaborative_gating(self, experts, ind, train, generator, dp):
    """The collaborative-experts reasoning path (mmt_tpu/models/cenet.py:
    _collaborative_gating) over experts [B, M, D]: for each modality i,
    the mean over the available pairs (i, j), j != i, of
    g_reason_2(relu(drop(g_reason_1([e_i, e_j])))), then
    f_reason_2(relu(drop(f_reason_1(.)))) gates e_i through video_GU[i].
    The shared g / f layers run once over every pair / modality."""
    b, m, d = experts.shape
    p_drop = self.coll_dropout if train else 0.0
    first, second = self.coll_pairs
    fused = torch.cat([experts[:, first], experts[:, second]], -1)
    temp = dropout(self.g_reason_1(fused), p_drop, generator,
                   part=row_part(dp, fused))
    temp = self.g_reason_2(torch.relu(temp))                  # [B, P, D]
    avail = (ind[:, first] * ind[:, second]).float()          # [B, P]
    temp = (temp * avail[..., None]).view(b, m, m - 1, d).sum(2)
    avail_sum = avail.view(b, m, m - 1).sum(2)
    curr = temp / (avail_sum + 1e-11)[..., None]              # [B, M, D]
    curr = dropout(self.f_reason_1(curr), p_drop, generator,
                   part=row_part(dp, curr))
    curr = self.f_reason_2(torch.relu(curr))
    return torch.stack(
        [self.video_GU[mod](experts[:, i], curr[:, i], train=train, dp=dp)
         for i, mod in enumerate(self.modalities)], 1)


def similarity_from_outputs(outputs, merge: str):
  """MoE similarity from CENet outputs (caption axis unrolled)."""
  b, k, m, d = outputs["text_embds"].shape
  return similarity_ops.moe_similarity(
      outputs["text_embds"].reshape(b * k, m, d), outputs["vid_embds"],
      outputs["text_weights"].reshape(b * k, m), outputs["vid_weights"],
      merge=merge, num_caps=k)
