"""Batch invariants, checked on the host.

Port of mmt_tpu/utils/checks.py: the same invariants of the fixed-shape
batch schema, checked on the numpy batch before it goes to the device (the
JAX package checks them on the device with checkify).  The trainer runs
``validate_batch`` on the first batch of each epoch when the trainer
config sets ``sanity_checks: true``.
"""

from __future__ import annotations

import numpy as np


def _check(ok, what):
  if not bool(ok):
    raise ValueError(f"batch failed validation: {what}")


def validate_batch(batch) -> None:
  """Raise ValueError naming the failed invariant if the batch is
  malformed (numpy arrays, or tensors, which are copied to the host)."""
  host = lambda x: np.asarray(x.cpu() if hasattr(x, "cpu") else x)
  token_ids = host(batch["token_ids"])
  _check(np.all(token_ids[..., 0] >= 0), "negative token ids in batch")
  _check(np.all((token_ids[..., 1] == 0) | (token_ids[..., 1] == 1)),
         "token validity column must be 0/1")
  _check(np.all(np.sum(token_ids[..., 1], axis=-1) > 0),
         "caption with zero valid tokens")
  for mod, feats in batch["features"].items():
    feats = host(feats)
    _check(np.all(np.isfinite(feats)), "non-finite features")
    ind = host(batch["features_ind"][mod])
    _check(np.all((ind == 0) | (ind == 1)), "feature indicators must be 0/1")
    # padded rows must be zero
    _check(np.all(np.abs(feats) * (1 - ind)[..., None] == 0),
           "nonzero features at padded positions")
