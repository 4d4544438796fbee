"""Phase timers + perf log (utils/timing_utils.py:17-37,
utils/perf_log_utils.py:18-27 semantics) and a torch.profiler surface.

Port of mmt_tpu/utils/timing.py: ``AverageMeter`` and ``update_perf_log``
copied, ``profiler_trace`` on torch.profiler in place of jax.profiler.
"""

from __future__ import annotations

import contextlib
import json
import time
from typing import Dict


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
