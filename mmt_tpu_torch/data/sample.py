"""Per-sample transform: captions + variable-length features -> fixed shapes.

Pure-numpy host-side pipeline (no torch): reproduces the reference's
per-sample logic (base/base_dataset.py:572-896) — caption selection /
query-shuffling modes, sentence-window cropping by timestamp, temporal
encoding offsets, random (train) vs seeded-deterministic (eval) feature
subsampling, avg/max pooling, missing-expert zero fill + indicator masks,
tokenization + crop/pad — emitting exactly the batch schema of
base/base_dataset.py:876-896.

A copy of mmt_tpu/data/sample.py, both of its assembly paths: the
native one (the default; descriptors gathered by one C call per (batch,
expert) in data/native_assembler.py) and the Python one
(``MMT_TPU_NATIVE_ASSEMBLY=0``), bit-exact to each other.
"""

from __future__ import annotations

import dataclasses
import functools
import os
import re
from typing import Dict, List, Sequence

import numpy as np

from mmt_tpu_torch.data import native_assembler as nasm
from mmt_tpu_torch.data import stop_words

# Budget for the per-record padded-temporal-block memo (make_sample):
# the blocks are created AFTER a record is admitted to the RecordCache,
# so they are accounted separately from MMT_TPU_RECORD_CACHE_MB — once
# this budget is spent, samples compute blocks fresh instead of caching
# (0 disables the memo entirely).
_FEAT_BLOCK_CACHE_MB = int(os.environ.get("MMT_TPU_FEAT_BLOCK_CACHE_MB",
                                          "2048"))
_feat_block_bytes = 0


def crop_or_pad_tokens(token_ids: Sequence[int], max_text_words: int):
  """(ids, valid) pairs in a (max_text_words, 2) array
  (base/base_dataset.py:63-68)."""
  out = np.zeros((max_text_words, 2))
  keep = min(len(token_ids), max_text_words)
  out[:keep, 0] = token_ids[:keep]
  out[:keep, 1] = 1
  return out


@functools.lru_cache(maxsize=64)
def _missing_block(max_tokens: int, dim: int):
  """Constant (features, t, ind) block for a missing modality
  (read-only: samples alias it instead of re-zeroing per epoch)."""
  z = np.zeros((max_tokens, dim), np.float32)
  zt = np.ones((max_tokens,), np.float32)
  zi = np.zeros((max_tokens,), np.float32)
  for arr in (z, zt, zi):
    arr.flags.writeable = False
  return z, zt, zi


@functools.lru_cache(maxsize=64)
def _zero_row(dim: int) -> np.ndarray:
  row = np.zeros((1, dim), np.float32)
  row.flags.writeable = False
  return row


@functools.lru_cache(maxsize=4096)
def _eval_pick(n: int, keep: int) -> np.ndarray:
  """Deterministic eval subsample (base/base_dataset.py:71-115 uses a
  fresh RandomState(0) per call, so the pick depends only on (n, keep) —
  memoize it instead of reseeding numpy for every sample)."""
  return np.random.RandomState(0).choice(n, size=keep, replace=False)


def choose_or_pad_features(features, features_t, max_tokens, training,
                           shuffle=False, seed=0, rng=None):
  """Fixed-length subsample of a variable-length feature sequence.

  base/base_dataset.py:71-115 semantics: train picks with the live RNG,
  eval picks with RandomState(0) (bit-deterministic across epochs); picks
  are sorted to preserve temporal order; padding rows get t=1, ind=0.
  """
  feature_dim = features.shape[-1]
  # float32 end to end: collate emits float32 anyway, and float64
  # intermediates doubled the assembly bandwidth (the loader hot path,
  # docs/DATA.md).  Values are identical — the first float32 rounding
  # just moves from collate to here.
  out = np.zeros((max_tokens, feature_dim), dtype=np.float32)
  out_t = np.ones((max_tokens,), dtype=np.float32)
  out_ind = np.zeros((max_tokens,), dtype=np.float32)
  keep = min(len(features), max_tokens)
  if keep == len(features):
    # Choosing all elements without replacement then sorting is the
    # identity — skip the RNG work AND the fancy-index copy (the common
    # fixed-seg case).
    sel, sel_t = features[:keep], features_t[:keep]
  elif training:
    picker = rng if rng is not None else np.random
    pick = np.sort(picker.choice(len(features), size=keep, replace=False))
    sel, sel_t = features[pick], features_t[pick]
  else:
    pick = np.sort(_eval_pick(len(features), keep))
    sel, sel_t = features[pick], features_t[pick]
  out[:keep] = sel
  if shuffle and training:
    shuffled = np.array(sel_t)   # plain copy; shuffle is dtype-neutral
    np.random.RandomState(seed).shuffle(shuffled)
    out_t[:keep] = shuffled
  else:
    out_t[:keep] = sel_t
  out_ind[:keep] = 1
  return out, out_t, out_ind


def _clean_word(word: str) -> str:
  for ch in (".", ",", "?", "!"):
    word = word.replace(ch, "")
  return word.lower()


def _is_stop_word(word: str) -> bool:
  pure = _clean_word(word)
  if pure in stop_words.ENGLISH_STOP_WORDS or not pure.isalnum():
    return True
  return any(piece in stop_words.ENGLISH_STOP_WORDS
             for piece in pure.split("'"))


def remove_stop_words(cap, cap_t):
  """base/base_dataset.py:118-130 semantics."""
  res, res_t = [], []
  for word, word_t in zip(cap, cap_t):
    if not _is_stop_word(word):
      res.append(_clean_word(word))
      res_t.append(word_t)
  if not res:
    res.append(".")
    res_t.append(np.array([0.0, 0.0]))
  return res, res_t


def tokenize_caption(tokenizer, word_list, max_text_words: int) -> List[int]:
  """Join words -> sentence -> WordPiece ids with [CLS]/[SEP]
  (base/base_dataset.py:320-353 semantics: strip, ensure trailing
  punctuation, capitalize, truncate keeping the [SEP] terminal)."""
  assert len(word_list) > 0, "empty caption"
  text = " ".join(str(w) for w in word_list).strip()
  if text[-1] not in (".", "?", "!"):
    text += "."
  text = text.capitalize()
  tokens = [tokenizer.cls_token] + tokenizer.tokenize(text) + [tokenizer.sep_token]
  tokens = tokens[:max_text_words]
  tokens[-1] = tokenizer.sep_token
  return tokenizer.convert_tokens_to_ids(tokens)


@dataclasses.dataclass
class SampleOptions:
  """Per-dataset sampling knobs (mix-entry args)."""
  max_text_words: int = 30
  max_expert_tokens: int = 8
  captions_per_video: int = 1
  query_shuffling: str = "indiv"     # indiv | cat | shuf | shufk<N>
  temporal_encoding_window: float = 1.0
  clip_duration: object = float("inf")     # scalar or [min, max]
  caption_length: object = float("inf")    # scalar or [min, max]
  n_pairs: int = 1
  remove_stop_words: bool = False
  shuffle_feats_t: bool = False
  # HowTo100M features stop at 500s; drop later words
  # (base/base_dataset.py:657-659).
  max_words_start_time: float = 500.0


def select_captions(captions, captions_t, opts: SampleOptions, training,
                    rng) -> List:
  """Apply the query-shuffling mode (base/base_dataset.py:592-625)."""
  picked = min(len(captions), opts.captions_per_video)
  out, out_t = [], []
  mode = opts.query_shuffling
  for cap_nb in range(picked):
    if mode == "indiv":
      out.append(captions[cap_nb])
      out_t.append(captions_t[cap_nb])
      continue
    if mode == "cat":
      out.append(np.concatenate(captions))
      out_t.append(np.concatenate(captions_t))
      continue
    if mode == "shuf":
      order = rng.permutation(len(captions))
      out.append(np.concatenate([captions[i] for i in order]))
      out_t.append(np.concatenate([captions_t[i] for i in order]))
      continue
    z = re.match(r"shufk(\d*)", mode)
    if z:
      nb_keep = min(int(z.groups()[0]), len(captions))
      order = rng.permutation(len(captions))[:nb_keep]
      out.append(np.concatenate([captions[i] for i in order]))
      out_t.append(np.concatenate([captions_t[i] for i in order]))
      continue
    raise ValueError(f"unknown query_shuffling {mode!r}")
  return out, out_t


def _stack0(lst):
  """np.stack(lst, 0), cheap for the ubiquitous single-element case
  (n_pairs=1 / captions_per_video=1 in every published train config)."""
  return lst[0][None] if len(lst) == 1 else np.stack(lst, 0)


# Shared descriptor for a missing modality under the native assembler
# (the zero block is synthesized in C; _missing_block stays the Python-
# path equivalent).
_MISSING_SLOT = nasm.FeatSlot(0, 0, None, None, None, None, 0.0, 1.0)


def _row_slot(row: np.ndarray) -> "nasm.RowSlot":
  """Wrap a pooled row for the native row-copy (coercing exotic dtypes
  or non-contiguous layouts the C kernel doesn't handle)."""
  if not (row.flags.c_contiguous
          and row.dtype in (np.float32, np.float64)):
    row = np.ascontiguousarray(row, np.float32)
  return nasm.RowSlot(2, row)


def _cat0(lst):
  return lst[0] if len(lst) == 1 else np.concatenate(lst, 0)


def make_sample(record, tokenizer, experts: Dict[str, int],
                opts: SampleOptions, training: bool, idx: int,
                path: str = "", source: str = ""):
  """One video -> fixed-shape tensors + metadata lists.

  experts: name -> raw dim.  Returns the three-part dict the collate step
  consumes (text_tensors / vid_tensors / lists).
  """
  rng = np.random if training else np.random.RandomState(idx)

  # Cached records (readers.RecordCache) already hold decoded str arrays;
  # only re-decode for raw byte captions from uncached pkl tables.
  captions = [c if isinstance(c, np.ndarray) and c.dtype.kind == "U"
              else np.asarray([w.decode("UTF-8") if isinstance(w, bytes)
                               else str(w) for w in c])
              for c in record.captions]
  captions_t = [np.asarray(t) for t in record.captions_t]
  sel_caps, sel_caps_t = select_captions(captions, captions_t, opts,
                                         training, rng)

  # Sentence splitting per caption slot, with the 500 s word cutoff.
  split_sentences = []
  for cap_idx in range(opts.captions_per_video):
    if cap_idx < len(sel_caps):
      cap = sel_caps[cap_idx]
      cap_t = np.asarray(sel_caps_t[cap_idx], dtype=np.float64)
      if cap_t.ndim == 1:
        cap_t = np.zeros((len(cap), 2))
      keep = cap_t[:, 0] < opts.max_words_start_time
      cap = cap[keep][:, None]
      cap_t = cap_t[keep][:, None]
      if len(cap) < 1:
        cap = np.array([["."]])
        cap_t = np.array([[[0.0, 0.0]]])
    else:
      cap = np.array([["0"]])
      cap_t = np.array([[[0.0, 0.0]]])
    split_sentences.append((cap, cap_t))

  query_masks = np.zeros((opts.captions_per_video,))
  query_masks[:len(sel_caps)] = 1

  token_ids_list, query_masks_list = [], []
  raw_captions_list = []
  # Native-assembler mode: emit per-expert descriptors (FeatSlot/RowSlot
  # referencing the cached record arrays) instead of materialized blocks;
  # collate() gathers/casts/pads them in one C call per expert.  The
  # numpy RNG draws below happen at the SAME stream positions either way,
  # so both paths give the same batches.
  lazy = nasm.enabled()
  feats = {e: [] for e in experts}
  feats_t = {e: [] for e in experts}
  feats_ind = {e: [] for e in experts}
  feats_avg = {e: [] for e in experts}
  feats_max = {e: [] for e in experts}
  paths, sources = [], []

  def _range(v):
    return (v[0], v[1]) if isinstance(v, (list, tuple)) else (v, v)

  for _ in range(opts.n_pairs):
    token_ids = []
    raw_captions_pair = []
    selected_sentences_t = np.array([[0.0, 0.0]])
    for cap_idx in range(opts.captions_per_video):
      lo, hi = _range(opts.caption_length)
      nb_sentences = float("inf") if lo == float("inf") else rng.randint(
          int(lo), int(hi) + 1)
      clo, chi = _range(opts.clip_duration)
      clip_length = float("inf") if chi == float("inf") else rng.uniform(
          clo, chi)

      sentences, sentences_t = split_sentences[cap_idx]
      nb = int(min(nb_sentences, len(sentences)))
      choice = rng.randint(len(sentences) + 1 - nb)
      sel = np.concatenate(sentences[choice:choice + nb])
      sel_t = np.concatenate(sentences_t[choice:choice + nb])
      if opts.remove_stop_words:
        sel, sel_t = remove_stop_words(sel, sel_t)
        sel, sel_t = np.asarray(sel), np.asarray(sel_t)
      sel = sel[:opts.max_text_words]
      sel_t = np.asarray(sel_t)[:opts.max_text_words]
      selected_sentences_t = sel_t
      raw_captions_pair.append(sel)

      ids = tokenize_caption(tokenizer, sel, opts.max_text_words)
      token_ids.append(crop_or_pad_tokens(ids, opts.max_text_words))

    token_ids_list.append(_stack0(token_ids))
    query_masks_list.append(query_masks)
    raw_captions_list.append(raw_captions_pair)

    if clip_length == float("inf"):
      feat_start, feat_end = 0.0, float("inf")
    else:
      s0 = float(np.min(selected_sentences_t))
      s1 = float(np.max(selected_sentences_t))
      c_time = (s0 + s1) / 2.0
      feat_start = c_time - clip_length / 2.0
      feat_end = feat_start + clip_length

    for expert, raw_dim in experts.items():
      f_sel = None
      f_t_raw = None
      f_t_sel = None
      if expert in record.features:
        f = np.asarray(record.features[expert])
        f_t = np.asarray(record.features_t[expert])
        if clip_length == float("inf"):
          f_sel = f
          f_t_raw = f_t
          if not lazy:
            # temporal encoding starts at 2 s (base/base_dataset.py:776-781);
            # lazy mode defers the affine — the C kernel applies the same
            # (t - start) / window + 2 per gathered row.
            f_t_sel = (f_t - feat_start) / opts.temporal_encoding_window + 2
        else:
          keep = np.logical_and(feat_start <= f_t, f_t <= feat_end)
          if keep.sum() > 0:
            f_sel = f[keep]
            f_t_sel = ((f_t[keep] - feat_start)
                       / opts.temporal_encoding_window + 2)

      if f_sel is None:
        if lazy:
          feats[expert].append(_MISSING_SLOT)
        else:
          z, zt, zi = _missing_block(opts.max_expert_tokens, raw_dim)
          feats[expert].append(z)
          feats_t[expert].append(zt)
          feats_ind[expert].append(zi)
        avg = mx = _zero_row(raw_dim)
      else:
        # Parity with base/base_dataset.py:809-810: the on-disk feature
        # width must match the registry dim for this expert.
        assert f_sel.ndim == 2 and f_sel.shape[1] == raw_dim, (
            f"expert {expert!r}: feature dim {f_sel.shape[1]} != "
            f"registry dim {raw_dim}")
        if clip_length == float("inf"):
          # Full-span pooling is a per-record constant; memoized on the
          # (cached) record so samples don't recompute it every epoch.
          pooled = record.pooled_full.get(expert)
          if pooled is None:
            pooled = (np.mean(f_sel, axis=0, keepdims=True),
                      np.max(f_sel, axis=0, keepdims=True))
            for arr in pooled:
              arr.flags.writeable = False  # samples alias these (cache!)
            record.pooled_full[expert] = pooled
          avg, mx = pooled
        else:
          avg = np.mean(f_sel, axis=0, keepdims=True)
          mx = np.max(f_sel, axis=0, keepdims=True)
        # The padded temporal block is a per-record constant whenever no
        # train-RNG draw happens (full clip + identity pick, or the
        # deterministic eval pick) — memoized on the cached record, like
        # pooled_full above.  When the train pick IS random
        # (len > max_tokens), the global-RNG draw must happen every
        # epoch, so those samples bypass the memo.
        cacheable = (clip_length == float("inf")
                     and not (opts.shuffle_feats_t and training)
                     and (len(f_sel) <= opts.max_expert_tokens
                          or not training))
        cache_key = (expert, opts.max_expert_tokens,
                     opts.temporal_encoding_window, training)
        block = record.feat_blocks.get(cache_key) if cacheable else None
        raw_slot = None
        if block is None:
          global _feat_block_bytes
          want_cache = (cacheable and _FEAT_BLOCK_CACHE_MB
                        and _feat_block_bytes
                        < _FEAT_BLOCK_CACHE_MB * 1024 * 1024)
          if (lazy and not want_cache and f_t_raw is not None
              and not (opts.shuffle_feats_t and training)
              and nasm.raw_slot_ok(f_sel, f_t_raw)):
            # Raw descriptor: the C kernel gathers `keep` rows (the
            # choose_or_pad_features pick, drawn here so the RNG stream
            # position is unchanged), casts, applies the temporal affine,
            # and pads — no per-sample block is ever materialized.  This
            # is the steady-state path for training picks (len > max),
            # which the block memo can never cache.
            n_src = len(f_sel)
            keep_n = min(n_src, opts.max_expert_tokens)
            if keep_n == n_src:
              pick = None
            elif training:
              pick = np.sort(np.random.choice(
                  n_src, size=keep_n, replace=False)).astype(
                      np.int64, copy=False)
            else:
              pick = np.sort(_eval_pick(n_src, keep_n)).astype(
                  np.int64, copy=False)
            raw_slot = nasm.FeatSlot(2, keep_n, f_sel, f_t_raw, None,
                                     pick, feat_start,
                                     opts.temporal_encoding_window)
          else:
            if f_t_sel is None:
              f_t_sel = ((f_t_raw - feat_start)
                         / opts.temporal_encoding_window + 2)
            block = choose_or_pad_features(
                f_sel, f_t_sel, opts.max_expert_tokens, training,
                shuffle=opts.shuffle_feats_t, seed=idx)
            size = sum(a.nbytes for a in block)
            if (cacheable and _FEAT_BLOCK_CACHE_MB
                and _feat_block_bytes + size
                <= _FEAT_BLOCK_CACHE_MB * 1024 * 1024):
              for arr in block:
                arr.flags.writeable = False   # samples alias these (cache!)
              record.feat_blocks[cache_key] = block
              _feat_block_bytes += size
        if lazy:
          feats[expert].append(
              raw_slot if raw_slot is not None
              else nasm.FeatSlot(1, 0, *block, None, 0.0, 1.0))
        else:
          sub, sub_t, sub_ind = block
          feats[expert].append(sub)
          feats_t[expert].append(sub_t)
          feats_ind[expert].append(sub_ind)
      if record.features_avgpool.get(expert) is not None:
        avg = np.asarray(record.features_avgpool[expert]).reshape(1, -1)
      if record.features_maxpool.get(expert) is not None:
        mx = np.asarray(record.features_maxpool[expert]).reshape(1, -1)
      if lazy:
        feats_avg[expert].append(_row_slot(avg))
        feats_max[expert].append(_row_slot(mx))
      else:
        feats_avg[expert].append(avg)
        feats_max[expert].append(mx)

    paths.append(path)
    sources.append(source)

  if lazy:
    vid_tensors = {
        "feat_slots": feats,        # expert -> [FeatSlot per pair]
        "avg_slots": feats_avg,     # expert -> [RowSlot per pair]
        "max_slots": feats_max,
        "feat_T": opts.max_expert_tokens,
    }
  else:
    vid_tensors = {
        "features": {e: _stack0(feats[e]) for e in experts},
        "features_t": {e: _stack0(feats_t[e]) for e in experts},
        "features_ind": {e: _stack0(feats_ind[e]) for e in experts},
        "features_avgpool": {e: _cat0(feats_avg[e]) for e in experts},
        "features_maxpool": {e: _cat0(feats_max[e]) for e in experts},
    }
  return {
      "text_tensors": {
          "token_ids": _stack0(token_ids_list),
          "query_masks": _stack0(query_masks_list),
      },
      "vid_tensors": vid_tensors,
      "lists": {
          "raw_captions": raw_captions_list,
          "paths": paths,
          "sources": sources,
      },
  }


def collate(samples, experts) -> Dict:
  """Stack per-sample dicts into one fixed-shape batch
  (base/base_dataset.py:392-424 schema: int32 text, float32 video)."""
  text = {}
  for key in samples[0]["text_tensors"]:
    text[key] = np.concatenate(
        [s["text_tensors"][key] for s in samples], 0).astype(
            np.int32, copy=False)
  vid = {}
  if "feat_slots" in samples[0]["vid_tensors"]:
    # Native-assembler mode (native_assembler.enabled()): samples carry
    # descriptors; one C call per expert writes each batch tensor.
    T = samples[0]["vid_tensors"]["feat_T"]
    if any(s["vid_tensors"]["feat_T"] != T for s in samples):
      raise ValueError("mixed max_expert_tokens in one batch")
    for name in ("features", "features_t", "features_ind",
                 "features_avgpool", "features_maxpool"):
      vid[name] = {}
    for e in experts:
      dim = experts[e]
      slots = [sl for s in samples
               for sl in s["vid_tensors"]["feat_slots"][e]]
      (vid["features"][e], vid["features_t"][e],
       vid["features_ind"][e]) = nasm.assemble_features(slots, T, dim)
      vid["features_avgpool"][e] = nasm.assemble_rows(
          [sl for s in samples for sl in s["vid_tensors"]["avg_slots"][e]],
          dim)
      vid["features_maxpool"][e] = nasm.assemble_rows(
          [sl for s in samples for sl in s["vid_tensors"]["max_slots"][e]],
          dim)
  else:
    for key in samples[0]["vid_tensors"]:
      # dtype= makes the concat write float32 directly (single pass) —
      # .astype after a float64 concat did the copy twice.
      vid[key] = {e: np.concatenate(
          [s["vid_tensors"][key][e] for s in samples], 0, dtype=np.float32)
          for e in experts}
  lists = {}
  for key in samples[0]["lists"]:
    out = []
    for s in samples:
      out.extend(s["lists"][key])
    lists[key] = out
  return {**text, **vid, **lists}
