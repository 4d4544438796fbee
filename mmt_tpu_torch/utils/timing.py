"""Phase timers + perf log (utils/timing_utils.py:17-37,
utils/perf_log_utils.py:18-27 semantics) and a torch.profiler surface.

Port of mmt_tpu/utils/timing.py: ``AverageMeter`` and ``update_perf_log``
copied, ``profiler_trace`` on torch.profiler in place of jax.profiler.
``span`` names the program's ranges on the profiler's timeline:

  mmt.step                 train/step.py: one ``train_step`` call, and in it
  mmt.step.forward           the towers (and the data group's gather)
  mmt.step.loss              the similarity and the loss
  mmt.step.backward          ``loss.backward()`` (and the gradients' all-reduce)
  mmt.step.optimizer         ``optimizer.step()``
  mmt.step.graph             the replay of a captured step, in place of the
                             four above (which run only while it is captured)
  mmt.tower.text           models/cenet.py: ``embed_text``
  mmt.tower.video          models/cenet.py: ``embed_video``
  mmt.tower.text.mla       models/moe_text.py: a layer's latent attention
  mmt.moe.route            models/moe_text.py: an MoE layer's router, its
                           choices and counters (and its balance loss)
  mmt.moe.experts          models/moe_text.py: the held experts' part
                           (ops/moe.py, the grouped kernels on the card)
  mmt.moe.shared           models/moe_text.py: the shared experts
  mmt.ffn_op.fwd           ops/ffn.py: the FFN block's forward (B1, B2, B6,
                           B7 or their plain versions)
  mmt.ffn_op.bwd           ops/ffn.py: its backward (B3 or its plain version)
  mmt.ffn_wgrad            ops/ffn.py: its weight gradients (library GEMMs)
  mmt.similarity           ops/similarity.py: ``moe_similarity``
  mmt.ranks                ops/ranking.py: the matrix ranks, ``fused_counts``
  mmt.eval                 evaluate.py: one ``retrieval_eval`` call, and in it
  mmt.eval.embed             a chunk of the corpus through the towers
  mmt.eval.similarity        the [Q, V] similarity
  mmt.eval.ranks             the ranks, the metrics and their host reads
  mmt.loader.wait          train/trainer.py: one batch from the loader

On the card each range also becomes a device-side annotation, which holds
the kernels launched in it by its own thread and outside any range
nested in it: the backward's kernels, which autograd's device thread
launches, lie in ``mmt.ffn_op.bwd`` and ``mmt.ffn_wgrad`` and in no range
opened on the main thread.
"""

from __future__ import annotations

import contextlib
import json
import time
from typing import Dict

from torch.autograd import profiler as _autograd_profiler

_NULL = contextlib.nullcontext()
_END = object()


class AverageMeter:
  """Keyed val/sum/count/avg accumulator."""

  def __init__(self):
    self.dic: Dict[str, Dict[str, float]] = {}

  def update(self, key: str, val: float, n: int = 1):
    entry = self.dic.setdefault(key, {"val": 0.0, "sum": 0.0, "count": 0,
                                      "avg": 0.0})
    entry["val"] = val
    entry["sum"] += val * n
    entry["count"] += n
    entry["avg"] = entry["sum"] / entry["count"]

  def reset(self):
    self.dic = {}

  @contextlib.contextmanager
  def time(self, key: str):
    tic = time.time()
    try:
      yield
    finally:
      self.update(key, time.time() - tic)


def update_perf_log(entries: dict, path):
  """Append one line per epoch to the perf log."""
  with open(path, "a") as f:
    f.write(json.dumps(entries, default=str) + "\n")


def export_trace(prof, logdir):
  """Write a torch.profiler session as a Chrome trace,
  ``<logdir>/trace.json``; returns its path."""
  import pathlib

  out = pathlib.Path(logdir)
  out.mkdir(parents=True, exist_ok=True)
  prof.export_chrome_trace(str(out / "trace.json"))
  return out / "trace.json"


def span(name: str):
  """A context manager naming a range of the program ``name``: while a
  torch.profiler session records, ``torch.profiler.record_function(name)``
  (a host event and, on the card, a device-side annotation, both on the
  profiler's clock); otherwise one shared null context, after a single
  flag check.  A span changes no value."""
  if _autograd_profiler._is_profiler_enabled:
    return _autograd_profiler.record_function(name)
  return _NULL


def spanned(iterable, name: str):
  """The items of ``iterable``, each ``next()`` inside ``span(name)``."""
  it = iter(iterable)
  while True:
    with span(name):
      item = next(it, _END)
    if item is _END:
      return
    yield item


@contextlib.contextmanager
def profiler_trace(logdir, enabled: bool = False):
  """torch.profiler trace around a region (host and, where there is a
  card, device activity), written as a Chrome trace to
  ``<logdir>/trace.json``."""
  if not enabled:
    yield
    return
  import torch

  activities = [torch.profiler.ProfilerActivity.CPU]
  if torch.cuda.is_available():
    activities.append(torch.profiler.ProfilerActivity.CUDA)
  with torch.profiler.profile(activities=activities) as prof:
    yield
  export_trace(prof, logdir)
