"""Dataset catalog: split configuration for the 7 supported corpora.

The reference implements 7 near-identical dataset classes
(data_loader/*_dataset.py) that differ only in list-file names, cross-val
behavior, and a few corpus quirks.  Here the catalog is declarative — one
split engine + per-dataset ``DatasetSpec`` entries:

* MSRVTT  (cuts miech/jsfusion/full/c; jsfusion restricts test captions
  via jsfusion_val_caption_idx.pkl — data_loader/msrvtt_dataset.py:27-155)
* ActivityNet (val1/c — activitynet_dataset.py:25-140)
* LSMDC   (full; drops 5 caption-less training videos —
  lsmdc_dataset.py:25-80)
* HowTo100M (full — howto100m_dataset.py:23-49)
* MSVD / DiDeMo / YouCook2 (full/c with trn-size caps)

A copy of mmt_tpu/data/datasets.py (the port imports nothing of the JAX
package).
"""

from __future__ import annotations

import dataclasses
import os
import pathlib
from typing import Callable, Dict, List, Optional

import numpy as np

from mmt_tpu_torch.data.readers import (MultH5Reader, PklReader, RecordCache,
                                  VideoRecord, discover_expert_paths,
                                  memcache)
from mmt_tpu_torch.data.sample import SampleOptions, collate, make_sample


def _read_list(path) -> List[str]:
  with open(path) as f:
    return [x.strip() for x in f.readlines()]


def _read_csv_col0(path) -> List[str]:
  out = []
  with open(path) as f:
    for line in f:
      line = line.rstrip("\n")
      if line:
        out.append(line.split("\t")[0].strip())
  return out


@dataclasses.dataclass
class CutSpec:
  """How one cut of a dataset defines its video lists."""
  train_list: Optional[str] = None
  test_list: Optional[str] = None
  val_list: Optional[str] = None
  # cross-split style: 'heldout' = shuffle(train) and carve test-sized
  # val from the front; 'concat' = train+val lists with optional reshuffle
  # (challenge cuts); 'direct' = one list per split.
  style: str = "heldout"
  trn_cap: Optional[int] = None          # cap on the trn monitoring split
  reader: str = "mult_h5"                # 'mult_h5' | 'pkl'
  list_reader: Callable = _read_list
  in_root_feat: bool = False             # lists live under symlinked-feats
  restrict_test_captions_file: Optional[str] = None
  direct_lists: Optional[Dict[str, str]] = None


@dataclasses.dataclass
class DatasetSpec:
  name: str
  cuts: Dict[str, CutSpec]
  drop_videos: tuple = ()                # corpus quirks (LSMDC)


DATASET_CATALOG: Dict[str, DatasetSpec] = {
    "MSRVTT": DatasetSpec("MSRVTT", {
        "miech": CutSpec(train_list="train_list_miech.txt",
                         test_list="test_list_miech.txt"),
        "jsfusion": CutSpec(
            train_list="train_list_jsfusion.txt",
            test_list="val_list_jsfusion.txt",
            restrict_test_captions_file="jsfusion_val_caption_idx.pkl"),
        "full": CutSpec(style="direct", trn_cap=497,
                        direct_lists={"train": "train_list.txt",
                                      "trn": "train_list.txt",
                                      "val": "val_list.txt",
                                      "test": "test_list.txt"}),
        "c": CutSpec(train_list="train_list.txt", val_list="val_list.txt",
                     style="concat", reader="pkl"),
    }),
    "ActivityNet": DatasetSpec("ActivityNet", {
        "val1": CutSpec(train_list="train_list.txt",
                        test_list="val_1_list.txt"),
        "c": CutSpec(train_list="train_list.txt", val_list="val_list.txt",
                     style="concat", reader="pkl"),
    }),
    "LSMDC": DatasetSpec("LSMDC", {
        "full": CutSpec(train_list="LSMDC16_annos_training.csv",
                        test_list="LSMDC16_challenge_1000_publictect.csv",
                        list_reader=_read_csv_col0),
    }, drop_videos=(
        "0024_THE_LORD_OF_THE_RINGS_THE_FELLOWSHIP_OF_THE_RING_"
        "00.31.10.217-00.31.10.706",
        "1014_2012_00.01.21.399-00.01.23.997",
        "1014_2012_00.27.58.174-00.27.59.021",
        "1018_Body_Of_Lies_00.42.15.677-00.42.18.534",
        "1037_The_Curious_Case_Of_Benjamin_Button_02.25.14.743-02.25.17.312",
    )),
    "HowTo100M": DatasetSpec("HowTo100M", {
        "full": CutSpec(style="direct", in_root_feat=True,
                        direct_lists={"train": "train_list_full.txt",
                                      "trn": "trn_list_full.txt",
                                      "val": "val_list_full.txt",
                                      "valong": "val_list_full.txt",
                                      "val3-30": "val_list_full.txt",
                                      "test": "test_list_full.txt",
                                      "testlong": "test_list_full.txt",
                                      "test3-30": "test_list_full.txt"}),
    }),
    "MSVD": DatasetSpec("MSVD", {
        "full": CutSpec(style="direct", in_root_feat=True, trn_cap=670,
                        direct_lists={"train": "train_list.txt",
                                      "trn": "train_list.txt",
                                      "val": "val_list.txt",
                                      "test": "test_list.txt"}),
        "c": CutSpec(train_list="train_list.txt", val_list="val_list.txt",
                     style="concat", reader="pkl", trn_cap=120),
    }),
    "DiDeMo": DatasetSpec("DiDeMo", {
        "full": CutSpec(style="direct", in_root_feat=True, trn_cap=1065,
                        direct_lists={"train": "train_list.txt",
                                      "trn": "train_list.txt",
                                      "val": "val_list.txt",
                                      "test": "test_list.txt"}),
        "c": CutSpec(train_list="train_list.txt", val_list="val_list.txt",
                     style="concat", reader="pkl", trn_cap=840),
    }),
    "YouCook2": DatasetSpec("YouCook2", {
        "full": CutSpec(style="direct", in_root_feat=True,
                        direct_lists={"train": "train_list.txt",
                                      "trn": "train_list.txt",
                                      "val": "val_list.txt",
                                      "test": "test_list.txt"}),
        "c": CutSpec(train_list="train_list.txt", val_list="val_list.txt",
                     style="concat", reader="pkl"),
    }),
}


def resolve_split(spec: DatasetSpec, cut: CutSpec, data_dir, cut_name: str,
                  split_name: str, cross_seed: int) -> List[str]:
  """Shared split engine covering the three reference styles."""
  base = (pathlib.Path(data_dir) / "symlinked-feats" if cut.in_root_feat
          else pathlib.Path(data_dir))

  if cut.style == "direct":
    try:
      rel = cut.direct_lists[split_name]
    except KeyError:
      raise ValueError(f"unrecognised split: {split_name}") from None
    vids = cut.list_reader(base / rel)
    if split_name == "trn" and cut.trn_cap:
      rng = np.random.RandomState(0)
      rng.shuffle(vids)
      vids = vids[:cut.trn_cap]
    return vids

  if cut.style == "heldout":
    # Shuffle(train) by cross_seed; 'val' = first test-sized chunk,
    # 'train' = rest, 'trainval' = all, 'trn' = train capped to test size
    # (msrvtt_dataset.py:52-79 and the identical LSMDC/ActivityNet logic).
    test_vids = cut.list_reader(base / cut.test_list)
    nb_test = len(test_vids)
    if split_name == "test":
      return test_vids
    vids = [x.strip() for x in cut.list_reader(base / cut.train_list)]
    rng = np.random.RandomState(cross_seed)
    rng.shuffle(vids)
    if split_name == "trainval":
      return vids
    if split_name in ("train", "trn"):
      out = vids[nb_test:]
      return out[:nb_test] if split_name == "trn" else out
    if split_name == "val":
      return vids[:nb_test]
    raise ValueError(f"unrecognised split: {split_name}")

  if cut.style == "concat":
    # Challenge cuts: train+val concatenated; reshuffle only when
    # cross_seed != 0 (msrvtt_dataset.py:102-147).
    if split_name in ("train", "trn", "val", "trainval"):
      train_vids = cut.list_reader(base / cut.train_list)
      val_vids = cut.list_reader(base / cut.val_list)
      nb_train, nb_val = len(train_vids), len(val_vids)
      vids = [x.strip() for x in train_vids + val_vids]
      if cross_seed != 0:
        rng = np.random.RandomState(cross_seed)
        rng.shuffle(vids)
      if split_name == "trainval":
        return vids
      if split_name in ("train", "trn"):
        out = vids[:nb_train]
        if split_name == "trn":
          rng = np.random.RandomState(0)
          rng.shuffle(out)
          cap = cut.trn_cap if cut.trn_cap else nb_val
          out = out[:cap]
        return out
      return vids[nb_train:]  # val
    if split_name == "test1":
      return cut.list_reader(base / "public_server_val.txt")
    if split_name == "test2":
      return cut.list_reader(base / "public_server_test.txt")
    raise ValueError(f"unrecognised split: {split_name}")

  raise ValueError(f"unknown split style {cut.style}")


class ExpertDataset:
  """One (dataset, cut, split): video list + reader + per-sample transform.

  The reference equivalent is BaseDataset + a per-corpus subclass
  (base/base_dataset.py:133-318).
  """

  def __init__(self, dataset_name, cut_name, split_name, data_dir,
               raw_input_dims, training=False, tokenizer=None,
               cross_seed=0, load_in_ram=False, split_size=1.0,
               restrict_train_captions=0, loaded_data=None, **sample_opts):
    # restrict_train_captions is accepted-inert, as in the reference: it
    # is assigned but never consulted past __init__ there either
    # (base/base_dataset.py:177).
    del restrict_train_captions
    spec = DATASET_CATALOG[dataset_name]
    try:
      cut = spec.cuts[cut_name]
    except KeyError:
      raise ValueError(f"unrecognised cut: {cut_name}") from None
    self.spec, self.cut = spec, cut
    self.dataset_name = f"{dataset_name}_{cut_name}_{split_name}"
    self.split_name = split_name
    self.cut_name = cut_name
    self.data_dir = data_dir
    self.train = training
    self.tokenizer = tokenizer
    self.raw_input_dims = dict(raw_input_dims)
    self.experts = {m: d["dim"] if isinstance(d, dict) else d
                    for m, d in raw_input_dims.items()}
    known = {"max_text_words", "max_expert_tokens", "captions_per_video",
             "query_shuffling", "temporal_encoding_window", "clip_duration",
             "caption_length", "n_pairs", "remove_stop_words",
             "shuffle_feats_t"}
    unknown = set(sample_opts) - known
    assert not unknown, f"unknown dataset args: {unknown}"
    self.opts = SampleOptions(**sample_opts)
    if training:
      # One caption per video in training minibatches
      # (base/base_dataset.py:215-221).
      self.opts.captions_per_video = 1
    self.n_pairs = self.opts.n_pairs

    vids = resolve_split(spec, cut, data_dir, cut_name, split_name,
                         cross_seed)
    for v in spec.drop_videos:
      if v in vids:
        vids.remove(v)

    # split_size: int = sample count, float = keep ratio
    # (base/base_dataset.py:229-238).
    if isinstance(split_size, int) and split_size >= 2:
      vids = vids[:split_size]
    elif isinstance(split_size, float) and 0 <= split_size <= 1:
      vids = vids[:int(split_size * len(vids))]
    self.vid_list = vids
    self.num_train = len(vids)

    # Shared cross-loader table cache (reference loaded_data semantics,
    # base/base_dataset.py:283-296): one dict created in train.py and
    # passed through every loader so challenge pkl tables load once.
    self.restrict_test_captions = None
    if cut.restrict_test_captions_file:
      self.restrict_test_captions = memcache(
          pathlib.Path(data_dir) / cut.restrict_test_captions_file,
          loaded_data)

    # Budget-capped RAM record cache, shared across the train/continuous/
    # final loaders of the same corpus through loaded_data (records are
    # keyed by vid, which is split-independent for h5; pkl captions differ
    # for test2, so that split gets its own cache).  See readers.py for
    # why.
    def shared_record_cache(*key):
      if loaded_data is None:
        return RecordCache()
      return loaded_data.setdefault(("record_cache",) + key, RecordCache())

    if cut.reader == "pkl":
      expert_paths = discover_expert_paths(data_dir)
      self.reader = PklReader(data_dir, expert_paths, self.experts,
                              split_name=split_name, cache=loaded_data,
                              record_cache=shared_record_cache(
                                  "pkl", str(data_dir),
                                  split_name == "test2"))
    else:
      cache_dir = os.path.join(os.path.dirname(str(data_dir)),
                               "vid_feat_files", "mult_h5")
      self.reader = MultH5Reader(cache_dir, self.experts,
                                 cache=shared_record_cache("h5", cache_dir))

    self._ram: Dict[str, VideoRecord] = {}
    if load_in_ram:
      for vid in self.vid_list:
        self._ram[vid] = self.reader.read(vid)

  def __len__(self):
    # Training length is decided by the trainer (max_samples_per_epoch);
    # base/base_dataset.py:564-570.
    return max(self.num_train, int(1e6)) if self.train else self.num_train

  def record_for(self, vid: str) -> VideoRecord:
    if vid in self._ram:
      return self._ram[vid]
    return self.reader.read(vid)

  def __getitem__(self, idx):
    idx = idx % self.num_train
    vid = self.vid_list[idx]
    record = self.record_for(vid)
    if self.restrict_test_captions is not None and vid in self.restrict_test_captions:
      keep = self.restrict_test_captions[vid]
      record = VideoRecord([record.captions[keep]], [record.captions_t[keep]],
                           record.features, record.features_t,
                           record.features_avgpool, record.features_maxpool)
    path = str(pathlib.Path(self.data_dir) / f"videos/{vid}.mp4")
    return make_sample(record, self.tokenizer, self.experts, self.opts,
                       self.train, idx, path=path, source=self.dataset_name)

  def collate_data(self, samples):
    return collate(samples, self.experts)
