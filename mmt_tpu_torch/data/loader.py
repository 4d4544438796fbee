"""Batch loader: thread-pool sample assembly + prefetch ring + device copy.

Port of mmt_tpu/data/loader.py.  ``BatchLoader`` and ``ExpertDataLoader``
are the JAX package's (thread-pool workers feeding fixed-shape numpy
batches; the reference's fork-based torch DataLoader,
data_loader/data_loaders.py:23-70, is not used).  ``device_prefetch``
replaces the JAX package's device_put ring: each batch's arrays become
pinned host tensors, copied with ``non_blocking=True`` on a CUDA side
stream ``size`` batches ahead of the consumer, which waits on an event
recorded per batch (the reference's pin_memory + async copies).

Batches equal the JAX loader's only with ``num_workers=0``: shuffling and
the per-sample transforms draw from the seeded global numpy RNG, and
workers consume it in no fixed order (in both packages).

Under data parallelism every rank builds the same loaders from the same
seed and assembles the same global batches in lockstep (the trainer keeps
the rank's rows of each, on the host, before ``device_prefetch`` copies
them).  As above, that holds only with ``num_workers=0``, so
``ExpertDataLoader`` in a group of more than one process runs its loader
at 0 workers and says so (mmt_tpu/data/loader.py:140-149).
"""

from __future__ import annotations

import collections
import itertools
import logging
from concurrent.futures import ThreadPoolExecutor
from typing import Iterator, Optional

import numpy as np
import torch
import torch.distributed as dist

from mmt_tpu_torch.data.mix import MixDataset
from mmt_tpu_torch.registry import register

logger = logging.getLogger(__name__)


class BatchLoader:
  """Iterable over collated batches of a MixDataset."""

  def __init__(self, dataset, batch_size: int, num_workers: int = 0,
               shuffle: bool = False, drop_last: bool = False,
               prefetch_batches: int = 4, seed: Optional[int] = None):
    self.dataset = dataset
    self.batch_size = batch_size
    self.num_workers = num_workers
    self.shuffle = shuffle
    self.drop_last = drop_last
    self.prefetch_batches = prefetch_batches
    self.seed = seed

  def __len__(self):
    n = len(self.dataset)
    if self.drop_last:
      return n // self.batch_size
    return (n + self.batch_size - 1) // self.batch_size

  def _index_batches(self):
    n = len(self.dataset)
    if self.shuffle:
      # Training: random order; for the synthetic 1e7-length train sets a
      # full permutation is wasteful, so sample indices directly.
      rng = np.random.RandomState(self.seed) if self.seed is not None else np.random
      if n > 1_000_000:
        while True:
          yield rng.randint(0, n, size=self.batch_size)
      else:
        order = rng.permutation(n)
        end = n - n % self.batch_size if self.drop_last else n
        for i in range(0, end, self.batch_size):
          yield order[i:i + self.batch_size]
    else:
      end = n - n % self.batch_size if self.drop_last else n
      for i in range(0, end, self.batch_size):
        yield np.arange(i, min(i + self.batch_size, n))

  def __iter__(self) -> Iterator[dict]:
    if self.num_workers <= 0:
      for idxs in self._index_batches():
        yield self.dataset.collate_data([self.dataset[i] for i in idxs])
      return
    yield from self._threaded_iter()

  def _threaded_iter(self):
    with ThreadPoolExecutor(max_workers=self.num_workers) as pool:
      pending = collections.deque()
      index_iter = self._index_batches()

      def assemble(idxs):
        return self.dataset.collate_data([self.dataset[i] for i in idxs])

      for idxs in itertools.islice(index_iter, self.prefetch_batches):
        pending.append(pool.submit(assemble, idxs))
      while pending:
        batch = pending.popleft().result()
        nxt = next(index_iter, None)
        if nxt is not None:
          pending.append(pool.submit(assemble, nxt))
        yield batch


def _map(batch, kind, fn):
  """``batch`` with ``fn`` applied to every leaf of type ``kind`` (in
  nested dicts); everything else (the list fields) passes through as it
  is."""
  if isinstance(batch, dict):
    return {k: _map(v, kind, fn) for k, v in batch.items()}
  return fn(batch) if isinstance(batch, kind) else batch


def _tensors(batch):
  if isinstance(batch, dict):
    for v in batch.values():
      yield from _tensors(v)
  elif isinstance(batch, torch.Tensor):
    yield batch


def device_prefetch(iterator, device, size: int = 2):
  """Batches of ``iterator`` (dicts of numpy arrays) as torch tensors on
  ``device``, copied ``size`` batches ahead of consumption.

  On a CUDA device each array becomes a pinned host tensor, copied with
  ``non_blocking=True`` on a side stream; the event recorded after each
  batch's copies is waited on by the consumer's current stream when the
  batch is handed out, and every tensor of the batch is recorded on that
  stream (``record_stream``), so the allocator does not reuse its memory
  before the consumer's work on it is done.  On a CPU device the arrays
  are only converted.  Non-array fields pass through unchanged.
  """
  device = torch.device(device)
  it = iter(iterator)
  if device.type != "cuda":
    for batch in it:
      yield _map(batch, np.ndarray, torch.from_numpy)
    return
  if not torch.cuda.is_available():
    raise RuntimeError(f"device_prefetch: no CUDA device for {device}")
  side = torch.cuda.Stream(device)
  consumer = torch.cuda.current_stream(device)

  def put(batch):
    pinned = _map(batch, np.ndarray,
                  lambda x: torch.from_numpy(np.ascontiguousarray(x))
                  .pin_memory())
    with torch.cuda.stream(side):
      out = _map(pinned, torch.Tensor,
                 lambda t: t.to(device, non_blocking=True))
      ready = torch.cuda.Event()
      ready.record(side)
    return out, ready

  buf = collections.deque()
  for batch in itertools.islice(it, size):
    buf.append(put(batch))
  while buf:
    out, ready = buf.popleft()
    consumer.wait_event(ready)
    for t in _tensors(out):
      t.record_stream(consumer)
    nxt = next(it, None)
    if nxt is not None:
      buf.append(put(nxt))
    yield out


@register("data_loader", "ExpertDataLoader")
class ExpertDataLoader:
  """Config-built loader entry (data_loader/data_loaders.py:23-70 schema)."""

  def __init__(self, mix, num_workers, batch_size, raw_input_dims,
               until_epoch=float("inf"), pin_memory=False, n_pairs=1,
               training=False, tokenizer=None, loaded_data=None,
               cross_seed=0):
    self.batch_size = batch_size
    self.until_epoch = until_epoch
    self.n_pairs = n_pairs
    # Every process of a group assembles the same global batches only if
    # the seeded numpy stream is drawn in one order: no worker threads.
    if num_workers and dist.is_initialized() and dist.get_world_size() > 1:
      logger.warning("multi-process run: num_workers %d -> 0, so that "
                     "every process assembles the same global batches",
                     num_workers)
      num_workers = 0
    dataset = MixDataset(mix=mix, raw_input_dims=raw_input_dims,
                         training=training, tokenizer=tokenizer,
                         n_pairs=n_pairs, loaded_data=loaded_data,
                         cross_seed=cross_seed)
    loader = BatchLoader(dataset, batch_size=batch_size,
                         num_workers=num_workers, shuffle=training,
                         drop_last=training)
    self.dataloaders = {"loader": loader, "dataset": dataset}

  def __getitem__(self, key):
    return self.dataloaders[key]
