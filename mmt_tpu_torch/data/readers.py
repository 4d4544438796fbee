"""Feature-file readers: per-video h5 bundles and aggregated pkl tables.

A copy of mmt_tpu/data/readers.py (the port imports nothing of the JAX
package).  ``h5py`` is imported only where an h5 file is read.

Layouts (reference: base/base_dataset.py:200-206, :427-562,
utils/util.py:96-151):

* ``mult_h5``: one h5 file per video at
  ``<cache_dir>/<v[0]>/<v[1]>/<v[2]>/<vid>.h5`` with datasets
  ``raw_captions.<i>``, optional ``raw_captions_t.<i>``,
  ``features.<expert>``, optional ``features_t.<expert>``.
* ``pkl``: aggregated pickles per expert (fixed_seg / avg / max tables
  keyed by video id) + a raw-captions pickle, discovered by filename
  conventions.
"""

from __future__ import annotations

import logging
import os
import pathlib
import pickle
from typing import Dict

import numpy as np

from mmt_tpu_torch.experts import EXPERT_REGISTRY, ExpertSpec, feature_timings

logger = logging.getLogger(__name__)


def memcache(path, cache=None):
  """Load a .pkl/.pickle/.npy file (utils/util.py:96-151 semantics).

  ``cache`` is an optional path-keyed dict shared across loaders (the
  reference's ``loaded_data``, base/base_dataset.py:283-296): the same
  table is read from disk once even when train/continuous/final-eval
  splits all need it.
  """
  if cache is not None:
    key = str(path)
    if key not in cache:
      cache[key] = memcache(path)
    return cache[key]
  suffix = pathlib.Path(path).suffix
  if suffix in {".pkl", ".pickle"}:
    with open(path, "rb") as f:
      return pickle.load(f, encoding="latin1")
  if suffix == ".npy":
    with open(path, "rb") as f:
      data = np.load(f, encoding="latin1", allow_pickle=True)
    if isinstance(data, np.ndarray) and data.size == 1:
      data = data[()]  # numpy dict storage convention
    return data
  raise ValueError(f"unknown suffix: {suffix}")


class VideoRecord:
  """One video's captions + per-expert features, in memory."""

  __slots__ = ("captions", "captions_t", "features", "features_t",
               "features_avgpool", "features_maxpool", "pooled_full",
               "feat_blocks")

  def __init__(self, captions, captions_t, features, features_t,
               features_avgpool=None, features_maxpool=None):
    self.captions = captions          # list of word arrays
    self.captions_t = captions_t      # list of (n_words, 2) arrays
    self.features = features          # dict expert -> (n, dim) or absent
    self.features_t = features_t      # dict expert -> (n,) center times
    self.features_avgpool = features_avgpool or {}
    self.features_maxpool = features_maxpool or {}
    # Memo for full-span avg/max pooling (expert -> (avg, max) rows):
    # with clip_duration=inf (every published config) the pooled values
    # are per-record constants, so samples shouldn't recompute them.
    self.pooled_full = {}
    # Memo for the padded temporal block (expert, max_tokens, window) ->
    # (feats, t, ind): a per-record constant whenever the token pick is
    # the identity or the deterministic eval pick (sample.py gates the
    # cases where the train RNG draws).
    self.feat_blocks = {}

  def _arrays(self):
    for group in (self.captions, self.captions_t, self.features.values(),
                  self.features_t.values(), self.features_avgpool.values(),
                  self.features_maxpool.values()):
      for arr in group:
        yield arr

  def nbytes(self) -> int:
    return sum(getattr(np.asarray(arr), "nbytes", 0)
               for arr in self._arrays())

  def freeze(self) -> None:
    """Mark every array read-only.  Samples may hold views/aliases of
    record arrays (sample.py fast paths), so a mutation downstream must
    raise instead of silently corrupting the shared cache."""
    for arr in self._arrays():
      if isinstance(arr, np.ndarray):
        arr.flags.writeable = False


# Cached records are frozen read-only (VideoRecord.freeze) — samples may
# alias record arrays through sample.py's fast paths, so mutations must
# raise rather than corrupt the shared cache.  Without it every epoch
# re-reads each video's files; the reference amortizes those reads across
# 64 DataLoader worker processes (base/base_dataset.py via torch
# DataLoader), the loader here across a thread pool at most.
RECORD_CACHE_MB = int(os.environ.get("MMT_TPU_RECORD_CACHE_MB", "8192"))


class RecordCache:
  """Fill-until-budget record cache (no eviction: epochs sweep the whole
  corpus, so LRU would thrash; beyond-budget records are simply re-read)."""

  def __init__(self, budget_bytes: int = RECORD_CACHE_MB * 2 ** 20):
    self.budget = budget_bytes
    self.used = 0
    self._store: Dict[str, VideoRecord] = {}

  def get(self, key):
    return self._store.get(key)

  def put(self, key, record: VideoRecord):
    if self.used >= self.budget or key in self._store:
      return
    record.freeze()
    self._store[key] = record
    self.used += record.nbytes()


def _timings_for(expert: str, nb_feats: int) -> np.ndarray:
  spec = EXPERT_REGISTRY.get(expert, ExpertSpec(expert, 0, 0, feat_width=None))
  return feature_timings(nb_feats, spec)


class MultH5Reader:
  """Per-video h5 reader (base/base_dataset.py:427-497 layout)."""

  # s3d/vggish carry their own stored timings; other experts derive them
  # from the registry widths (base/base_dataset.py:471-492).
  TIMED_FROM_FILE = ("s3d", "vggish")

  def __init__(self, cache_dir, experts, cache: RecordCache = None):
    self.cache_dir = str(cache_dir)
    self.experts = list(experts)
    self.cache = cache

  def path_for(self, vid: str) -> str:
    if vid.endswith(".h5"):
      return vid
    return os.path.join(self.cache_dir, vid[0], vid[1], vid[2], f"{vid}.h5")

  def read(self, vid: str) -> VideoRecord:
    if self.cache is not None:
      hit = self.cache.get(vid)
      if hit is not None:
        return hit
    import h5py
    path = self.path_for(vid)
    with h5py.File(path, "r") as f:
      # One key listing; h5py group membership tests are expensive at
      # this call rate.
      keys = set(f.keys())
      nb_captions = sum(1 for k in keys if k.startswith("raw_captions."))
      assert nb_captions > 0, f"no caption for {path}"
      captions, captions_t = [], []
      for i in range(nb_captions):
        cap = f[f"raw_captions.{i}"][()]
        # Decode bytes -> str once at read time (cached records make this
        # a per-corpus, not per-sample, cost).
        cap = np.asarray([w.decode("UTF-8") if isinstance(w, bytes)
                          else str(w) for w in cap])
        captions.append(cap)
        key_t = f"raw_captions_t.{i}"
        if key_t in keys:
          cap_t = f[key_t][()]
          if cap_t.shape[0] != len(cap):
            cap_t = cap_t[:len(cap)]
        else:
          cap_t = np.zeros((len(cap), 2))
        captions_t.append(np.asarray(cap_t, dtype=np.float64))

      features, features_t = {}, {}
      for expert in self.experts:
        key = f"features.{expert}"
        if key not in keys:
          continue
        x = f[key][()]
        if len(x) == 0 or np.isnan(x[0][0]):
          continue
        features[expert] = np.asarray(x)
        key_t = f"features_t.{expert}"
        if key_t in keys and expert in self.TIMED_FROM_FILE:
          t = np.asarray(f[key_t][()])
          if t.shape[0] != features[expert].shape[0]:
            logger.warning("Incorrect number of features_t values for %s", path)
            t = t[:features[expert].shape[0]]
        else:
          t = _timings_for(expert, features[expert].shape[0])
        features_t[expert] = np.average(t, axis=1)
    record = VideoRecord(captions, captions_t, features, features_t)
    if self.cache is not None:
      self.cache.put(vid, record)
    return record


class PklReader:
  """Aggregated-pickle reader (challenge layout,
  base/base_dataset.py:499-562)."""

  def __init__(self, data_dir, expert_paths, experts, split_name="train",
               cache=None, record_cache: RecordCache = None):
    self.data_dir = pathlib.Path(data_dir)
    self.expert_paths = expert_paths
    self.experts = list(experts)
    cap_key = ("raw_captions_test2" if split_name == "test2"
               else "raw_captions")
    self._captions = memcache(self.data_dir / expert_paths[cap_key], cache)
    self.record_cache = record_cache
    self._tables: Dict[str, Dict[str, dict]] = {}
    for expert in self.experts:
      if expert not in expert_paths:
        logger.warning("expert %s not available in %s", expert, data_dir)
        continue
      self._tables[expert] = {}
      for agg, rel in expert_paths[expert].items():
        self._tables[expert][agg] = memcache(self.data_dir / rel, cache)

  def read(self, vid: str) -> VideoRecord:
    if self.record_cache is not None:
      hit = self.record_cache.get(vid)
      if hit is not None:
        return hit
    raw = self._captions[vid]
    captions = list(raw)
    captions_t = [np.zeros((len(c), 2)) for c in captions]

    features, features_t = {}, {}
    avgpool, maxpool = {}, {}
    for expert in self.experts:
      tables = self._tables.get(expert, {})
      seg = tables.get("fixed_seg", {})
      if vid in seg:
        x = seg[vid]
        if not isinstance(x, float) and len(x) and not np.isnan(x[0][0]):
          features[expert] = np.asarray(x)
          t = _timings_for(expert, features[expert].shape[0])
          features_t[expert] = np.average(t, axis=1)
      for agg, store in (("avg", avgpool), ("max", maxpool)):
        table = tables.get(agg, {})
        if vid in table:
          x = table[vid]
          if len(x) and not np.isnan(np.asarray(x).flat[0]):
            store[expert] = np.asarray(x)
    record = VideoRecord(captions, captions_t, features, features_t,
                         avgpool, maxpool)
    if self.record_cache is not None:
      self.record_cache.put(vid, record)
    return record


def discover_expert_paths(data_dir) -> dict:
  """Map expert -> {fixed_seg/avg/max: relpath} by filename convention
  (utils/util.py:300-368 semantics)."""
  out: Dict[str, dict] = {}
  special_fixed = {
      "audio_c": ("Audio_MSRVTT_new.pickle", "vggish-audio-raw.pickle",
                  "vggish-raw.pickle"),
      "face_c": ("facefeats-avg.pickle", "face-avg.pickle"),
      "ocr_c": ("ocr-raw.pickle", "ocr-w2v.pkl", "ocr-feats.pkl",
                "ocr-w2v.pickle"),
      "speech_c": ("speech-w2v.pickle", "goog_w2v-speech-raw.pickle",
                   "stt_w2v.pickle"),
  }
  for dirpath, _, filenames in os.walk(data_dir):
    for fname in sorted(filenames):
      path = os.path.join(dirpath, fname)
      rel = os.path.relpath(path, data_dir)
      dir_name = os.path.basename(dirpath)
      if dir_name.startswith("aggregated"):
        mod = fname.split("-")[0].lower()
        if mod in ("ocr", "scene", "face", "audio", "speech"):
          mod = mod + "_c"
        if "r2p1d-ig65m-kinetics" in fname:
          mod = "r2p1dk"
        if "-logits" in fname:
          mod += "_logits"
        matched = False
        for cmod, names in special_fixed.items():
          if fname in names:
            out.setdefault(cmod, {})["fixed_seg"] = rel
            matched = True
            break
        if matched:
          continue
        if fname.endswith(("-max.pickle", "-max-logits.pickle")):
          out.setdefault(mod, {})["max"] = rel
        elif fname.endswith(("-avg.pickle", "-avg-logits.pickle")):
          out.setdefault(mod, {})["avg"] = rel
        elif fname.endswith(("-fixed_seg.pickle", "-fixed_seg-logits.pickle")):
          out.setdefault(mod, {})["fixed_seg"] = rel
      elif fname.startswith("raw-captions."):
        out["raw_captions"] = rel
      elif fname.startswith("raw-captions-test2."):
        out["raw_captions_test2"] = rel
  return out
