"""Weighted mixture of datasets (pretrain mixes).

Parity with data_loader/mix_dataset.py:31-175: normalized
mix weights, per-sample dataset choice with the live RNG at train and
RandomState(idx) at eval, dataset_name 'Mix'/'mic' for multi-set mixes.

A copy of mmt_tpu/data/mix.py (the port imports nothing of the JAX
package).
"""

from __future__ import annotations

from typing import Dict, List

import numpy as np

from mmt_tpu_torch.data.datasets import ExpertDataset


class MixDataset:
  """Samples each item from one of several datasets by weight."""

  def __init__(self, mix: List[Dict], raw_input_dims, training=False,
               tokenizer=None, n_pairs=1, loaded_data=None, cross_seed=0):
    self.mix = mix
    self.train = training
    self.n_pairs = n_pairs
    self.experts = set(raw_input_dims.keys())

    if len(mix) == 1:
      entry = mix[0]
      self.dataset_name = "_".join([entry["dataset_name"], entry["cut_name"],
                                    entry["split_name"]])
      self.split_name = entry["split_name"]
    else:
      self.dataset_name = "Mix"
      self.split_name = "mic"

    self.datasets: List[ExpertDataset] = []
    weights = []
    for entry in mix:
      cfg = dict(entry)
      weights.append(float(cfg.pop("mix_weight", 1)))
      self.datasets.append(ExpertDataset(
          **cfg, raw_input_dims=raw_input_dims, training=training,
          tokenizer=tokenizer, n_pairs=n_pairs, loaded_data=loaded_data,
          cross_seed=cross_seed))
    total = sum(weights)
    self.mix_weights = [w / total for w in weights]

  def __len__(self):
    if self.train:
      return int(1e7)
    if len(self.mix) == 1:
      return len(self.datasets[0])
    return 1000  # eval on a mix is not a normal configuration

  def __getitem__(self, idx):
    rng = np.random if self.train else np.random.RandomState(idx)
    dataset_nb = rng.choice(len(self.mix), p=self.mix_weights)
    return self.datasets[dataset_nb][idx]

  def collate_data(self, samples):
    return self.datasets[0].collate_data(samples)
