"""Synthetic fixture dataset: a tiny MSRVTT-shaped corpus on disk.

Generates the exact on-disk layout the real pipeline reads (mult_h5
per-video bundles + split list files + a WordPiece vocab), so tests and
benchmarks exercise readers -> sample transform -> loader -> model end to
end without the 100GB+ real features (SURVEY.md §4 test strategy).

The captions are drawn from a small vocabulary with a deterministic
video-topic structure so that retrieval is *learnable*: each video gets a
topic word that also appears in its captions, and one expert stream
carries a topic-correlated signal.

A copy of mmt_tpu/data/synthetic.py with one difference: cut ``c`` (read
through the aggregated pickles) writes no per-video h5 files, so it needs
no ``h5py``.  The random draws those files took are still made, so every
array and list written is the JAX package's.
"""

from __future__ import annotations

import os
import pathlib
from typing import Dict, Optional

import numpy as np

TOPICS = [
    "cooking", "guitar", "soccer", "dancing", "surfing", "painting",
    "driving", "swimming", "running", "singing", "climbing", "skating",
    "reading", "typing", "boxing", "fishing", "juggling", "knitting",
    "skiing", "rowing", "drumming", "welding", "baking", "sailing",
    "archery", "bowling", "fencing", "karate", "sculpting", "gardening",
    "magic", "chess",
]
FILLER = [
    "a", "man", "woman", "is", "the", "with", "on", "in", "doing", "video",
    "shows", "person", "young", "group", "of", "people", "outside", "indoor",
]


def write_vocab(path):
  """A minimal WordPiece vocab covering the synthetic corpus."""
  tokens = ["[PAD]", "[UNK]", "[CLS]", "[SEP]", "[MASK]", ".", ",", "?", "!"]
  tokens += sorted(set(TOPICS + FILLER))
  # a few wordpiece continuations to exercise the subword path
  tokens += ["##ing", "##s", "##er", "cook", "paint", "surf", "swim"]
  path = pathlib.Path(path)
  path.parent.mkdir(parents=True, exist_ok=True)
  with open(path, "w") as f:
    f.write("\n".join(tokens) + "\n")
  return path


def write_large_vocab(path, seed: int = 0, n_words: int = 8000,
                      n_pieces: int = 4000):
  """A bert-base-cased-scale adversarial WordPiece vocab (10k+ entries).

  Stands in for the real 28,996-entry vocab
  (utils/nlp_utils.py:19-42; the asset cannot enter this
  environment): [unused] slots, full ASCII chars, ##-continuations,
  accented/CJK/Cyrillic/Greek tokens, so tokenizer parity is exercised at
  realistic scale and edge-case density.
  """
  rng = np.random.RandomState(seed)
  tokens = ["[PAD]"]
  tokens += [f"[unused{i}]" for i in range(99)]
  tokens += ["[UNK]", "[CLS]", "[SEP]", "[MASK]"]
  # single characters: printable ASCII + a unicode spread
  tokens += [chr(c) for c in range(33, 127)]
  tokens += list("àáâäæçèéêëìíîïñòóôöùúûüýÿßœ")
  tokens += [chr(c) for c in range(0x4E00, 0x4E00 + 64)]     # CJK
  tokens += [chr(c) for c in range(0x0430, 0x0450)]          # Cyrillic
  tokens += [chr(c) for c in range(0x03B1, 0x03C9)]          # Greek
  # synthetic word stock (deterministic letter n-grams)
  consonants = "bcdfghjklmnpqrstvwz"
  vowels = "aeiouy"
  seen = set(tokens)
  def syllable():
    return (consonants[rng.randint(len(consonants))]
            + vowels[rng.randint(len(vowels))])
  words = []
  while len(words) < n_words:
    w = "".join(syllable() for _ in range(rng.randint(1, 4)))
    if rng.rand() < 0.3:
      w = w.capitalize()
    if w not in seen:
      seen.add(w)
      words.append(w)
  tokens += words
  # continuation pieces, incl. unicode ones
  suffixes = ["ing", "er", "ed", "s", "es", "ly", "tion", "ment", "ness"]
  pieces = []
  for s in suffixes:
    pieces.append(f"##{s}")
  while len(pieces) < n_pieces:
    p = "##" + "".join(syllable() for _ in range(rng.randint(1, 3)))
    if p not in seen and p not in pieces:
      pieces.append(p)
  pieces += ["##é", "##ü", "##ß", "##'", "##-"]
  tokens += [p for p in dict.fromkeys(pieces)]
  # a handful of accented full words
  tokens += ["café", "über", "naïve", "résumé", "señor"]
  path = pathlib.Path(path)
  path.parent.mkdir(parents=True, exist_ok=True)
  with open(path, "w", encoding="utf-8") as f:
    f.write("\n".join(dict.fromkeys(tokens)) + "\n")
  return path


def generate(root, num_videos: int = 32, num_test: int = 8,
             experts: Optional[Dict[str, int]] = None,
             captions_per_video: int = 3, max_feats: int = 12,
             seed: int = 0, dataset: str = "MSRVTT",
             cut: str = "jsfusion") -> pathlib.Path:
  """Create the corpus under <root>/<dataset>; returns the data_dir.

  Layout (matching what ExpertDataset expects for mult_h5 cuts):
    <root>/<dataset>/                      data_dir (list files here)
    <root>/vid_feat_files/mult_h5/<v0>/<v1>/<v2>/<vid>.h5 (not for cut c)
  """
  write_h5 = cut != "c"
  if write_h5:
    import h5py

  experts = experts or {"rgb": 2048, "s3d": 1024}
  rng = np.random.RandomState(seed)
  root = pathlib.Path(root)
  data_dir = root / dataset
  data_dir.mkdir(parents=True, exist_ok=True)
  h5_root = root / "vid_feat_files" / "mult_h5"

  vids = [f"video{i:04d}" for i in range(num_videos)]
  # Topic assignment that makes retrieval learnable: test videos (the
  # first num_test) get pairwise-distinct topics (same-topic test videos
  # are indistinguishable), and every test topic also appears in the
  # training split (otherwise its word embedding is never trained).
  assert num_test <= len(TOPICS), (
      f"num_test ({num_test}) exceeds the {len(TOPICS)} distinct topics "
      "the synthetic corpus can assign (test videos need pairwise-"
      "distinct topics to be retrievable)")
  pool = rng.permutation(len(TOPICS))
  n_pool = max(num_test, min(len(TOPICS), num_videos - num_test))
  pool = pool[:n_pool]
  topic_ids = np.empty(num_videos, dtype=int)
  topic_ids[:num_test] = pool[:num_test]
  topic_ids[num_test:] = pool[rng.randint(0, n_pool,
                                          size=num_videos - num_test)]
  # guarantee coverage: each test topic occurs at least once in training
  for j, topic in enumerate(pool[:num_test]):
    if num_videos - num_test > j and topic not in topic_ids[num_test:]:
      topic_ids[num_test + j] = topic
  sig_dims = min(64, min(experts.values()) if experts else 16)
  topic_dirs = 2.0 * rng.randn(len(TOPICS), sig_dims)

  for vid, topic_id in zip(vids, topic_ids):
    topic = TOPICS[topic_id]
    arrays = {}
    for i in range(captions_per_video):
      n_fill = rng.randint(3, 7)
      words = [FILLER[j] for j in rng.randint(0, len(FILLER), n_fill)]
      pos = rng.randint(0, n_fill + 1)
      words.insert(pos, topic)
      arrays[f"raw_captions.{i}"] = np.array([w.encode() for w in words])
      arrays[f"raw_captions_t.{i}"] = np.stack(
          [np.arange(len(words), dtype=np.float64),
           np.arange(1, len(words) + 1, dtype=np.float64)], -1)
    for expert, dim in experts.items():
      n = rng.randint(2, max_feats + 1)
      feats = rng.randn(n, dim) * 0.1
      # topic-correlated signal in the first 16 dims
      feats[:, :sig_dims] += topic_dirs[topic_id]
      arrays[f"features.{expert}"] = feats
      arrays[f"features_t.{expert}"] = np.stack(
          [np.arange(n, dtype=np.float64),
           np.arange(1, n + 1, dtype=np.float64)], -1)
    if write_h5:
      out = h5_root / vid[0] / vid[1] / vid[2] / f"{vid}.h5"
      out.parent.mkdir(parents=True, exist_ok=True)
      with h5py.File(out, "w") as f:
        for key, value in arrays.items():
          f.create_dataset(key, data=value)

  # Split lists (MSRVTT jsfusion-style names).
  test_vids = vids[:num_test]
  train_vids = vids[num_test:]
  if cut == "c":
    # Challenge layout: aggregated pickles + public-server split lists
    # (the reference's cut 'c' path, base/base_dataset.py:200-206).
    import pickle
    agg_dir = data_dir / "aggregated_feats"
    agg_dir.mkdir(parents=True, exist_ok=True)
    captions = {}
    fixed_seg = {e: {} for e in experts}
    avg_t = {e: {} for e in experts}
    max_t = {e: {} for e in experts}
    for vid, topic_id in zip(vids, topic_ids):
      topic = TOPICS[topic_id]
      caps = []
      for _ in range(captions_per_video):
        n_fill = rng.randint(3, 7)
        words = [FILLER[j] for j in rng.randint(0, len(FILLER), n_fill)]
        words.insert(rng.randint(0, n_fill + 1), topic)
        caps.append(words)
      captions[vid] = caps
      for expert, dim in experts.items():
        n = rng.randint(2, max_feats + 1)
        feats = rng.randn(n, dim) * 0.1
        feats[:, :sig_dims] += topic_dirs[topic_id]
        fixed_seg[expert][vid] = feats
        avg_t[expert][vid] = feats.mean(0, keepdims=True)
        max_t[expert][vid] = feats.max(0, keepdims=True)
    with open(data_dir / "raw-captions.pkl", "wb") as f:
      pickle.dump(captions, f)
    for expert in experts:
      for agg, table in (("fixed_seg", fixed_seg), ("avg", avg_t),
                         ("max", max_t)):
        with open(agg_dir / f"{expert}-{agg}.pickle", "wb") as f:
          pickle.dump(table[expert], f)
    (data_dir / "train_list.txt").write_text("\n".join(train_vids) + "\n")
    (data_dir / "val_list.txt").write_text("\n".join(test_vids) + "\n")
    (data_dir / "public_server_val.txt").write_text(
        "\n".join(test_vids) + "\n")
    (data_dir / "public_server_test.txt").write_text(
        "\n".join(test_vids) + "\n")
    write_vocab(root / "vocab.txt")
    return data_dir
  if cut == "jsfusion":
    (data_dir / "train_list_jsfusion.txt").write_text(
        "\n".join(train_vids) + "\n")
    (data_dir / "val_list_jsfusion.txt").write_text(
        "\n".join(test_vids) + "\n")
    # jsfusion restricts each test video to one caption index.
    import pickle
    restrict = {v: int(rng.randint(0, captions_per_video)) for v in test_vids}
    with open(data_dir / "jsfusion_val_caption_idx.pkl", "wb") as f:
      pickle.dump(restrict, f)
  else:
    (data_dir / "train_list.txt").write_text("\n".join(train_vids) + "\n")
    (data_dir / "val_list.txt").write_text("\n".join(test_vids) + "\n")
    (data_dir / "test_list.txt").write_text("\n".join(test_vids) + "\n")

  write_vocab(root / "vocab.txt")
  return data_dir
