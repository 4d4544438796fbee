"""A run with the timed path broken underneath comes out not correct:
each fault a cell can have, planted in the program at test widths on the
CPU (the harness's look for a card is skipped).  One card, so no
exchange between chips to leave out."""

import time

import numpy as np
import pytest
import torch

import mmt_tpu_torch.ops.ranking as ranking
import mmt_tpu_torch.train.metrics as metrics_lib
import mmt_tpu_torch.train.step as step_lib
from mmt_tpu_torch.models.cenet import CENet
from perfbench import run
from perfbench.tests.tiny import tiny_cell


def _half(batch):
  return {k: (_half(v) if isinstance(v, dict) else v[:len(v) // 2])
          for k, v in batch.items()}


def unchanged_state(mp):
  mp.setattr(torch.optim.Adam, "step", lambda self, closure=None: None)


def half_batch(mp):
  step = step_lib.train_step
  mp.setattr(step_lib, "train_step",
             lambda model, opt, batch, **kw: step(model, opt, _half(batch),
                                                  **kw))


def altered_output(mp):
  embed = CENet.embed_video

  def altered(self, *args, **kw):
    out = embed(self, *args, **kw)
    out["vid_embds"] = out["vid_embds"].clone()
    out["vid_embds"][0, 0, 0] += 0.01
    return out

  mp.setattr(CENet, "embed_video", altered)


def altered_rank(mp):
  ranks = ranking.t2v_ranks

  def altered(sims):
    out = ranks(sims).clone()
    out[0] += 1
    return out

  mp.setattr(ranking, "t2v_ranks", altered)


def half_queries(mp):
  t2v = metrics_lib.t2v_metrics

  def half(sims, query_masks=None):
    keep = np.zeros(len(sims), np.float32)
    keep[:len(sims) // 2] = 1
    return t2v(sims, keep)

  mp.setattr(metrics_lib, "t2v_metrics", half)


FAULTS = [("msrvtt-train-b32", unchanged_state),
          ("msrvtt-train-b32", half_batch),
          ("activitynet-train-b32", altered_output),
          ("msrvtt-eval-1k", altered_output),
          ("msrvtt-eval-1k", altered_rank),
          ("activitynet-eval-val1", half_queries)]


@pytest.mark.parametrize("name,fault", FAULTS,
                         ids=[f"{n}-{f.__name__}" for n, f in FAULTS])
def test_fault_is_not_correct(name, fault, monkeypatch):
  fault(monkeypatch)
  result, table = run.run_cell(tiny_cell(name), 0.2, 0, time.time())
  assert not result["correct"], table
