"""The training program: ``mmt_tpu_torch.train.step.train_step`` over a
pool of distinct batches staged on the device, one step after another,
as the trainer drives it between loader batches.

Traffic parameters: ``batch`` (videos a step), ``captions_per_video``,
``pool_batches`` (distinct batches staged, taken in turn) and
``check_steps`` (the steps set-up takes through the same call, which the
reference follows).
"""

from __future__ import annotations

import sys
import time

import numpy as np
import torch

from mmt_tpu_torch.train import losses as losses_lib
from mmt_tpu_torch.train import optim as optim_lib
from mmt_tpu_torch.train import step as step_lib
from perfbench import checks, flops, inputs, port
from perfbench.reference import model as ref_model
from perfbench.reference import train as ref_train

KIND = "train"
SLICE_STEPS = 4


def unit_flops(cell):
  t = cell.traffic
  return flops.train_step_flops(cell.cfg, t["batch"], t["captions_per_video"])


def ffn_calls(cell):
  t = cell.traffic
  return flops.ffn_calls_train_step(cell.cfg, t["batch"],
                                    t["captions_per_video"])


class State:
  """The step object the set-up builds and the window drives."""

  def __init__(self, cell):
    cfg, t, dev = cell.cfg, cell.traffic, cell.device
    self.cell = cell
    weights = inputs.make_weights(cfg, cell.seed, dev)
    self.model = port.build_model(cfg, weights, dev).train(True)
    o = cfg["optimizer"]
    self.optimizer, self.lr = optim_lib.build_optimizer(
        {"type": o["type"], "args": {"lr": o["lr"],
                                     "weight_decay": o["weight_decay"],
                                     "betas": o["betas"], "eps": o["eps"]}},
        self.model.parameters())
    self.loss_fn = losses_lib.max_margin_ranking_loss(
        cfg["loss"]["margin"], cfg["loss"]["fix_norm"])
    self.generator = inputs.generator(cell.seed, inputs.DROPOUT, dev)
    self.pool = inputs.make_batches(
        cfg, [t["batch"]] * t["pool_batches"], cell.seed, dev,
        t["captions_per_video"])
    self.taken = 0
    self.checked = self._checked_steps(weights, t["check_steps"])

  def step(self):
    batch = self.pool[self.taken % len(self.pool)]
    self.taken += 1
    return step_lib.train_step(self.model, self.optimizer, batch,
                               loss_fn=self.loss_fn, lr=self.lr,
                               generator=self.generator)

  def _checked_steps(self, weights, n):
    """The first ``n`` steps, through ``step``: each loss, the first
    step's tower outputs and gradient norms (from Adam's first moment),
    and the change of every leaf after the n."""
    outputs = []
    hook = self.model.register_forward_hook(
        lambda mod, args, out: outputs.append(checks.to_host(out)))
    losses, grads = [], None
    beta1 = self.cell.cfg["optimizer"]["betas"][0]
    for i in range(n):
      losses.append(self.step())
      if i == 0:
        hook.remove()
        state = self.optimizer.state
        grads = checks.leaf_norms(
            (name, state[p]["exp_avg"] / (1 - beta1))
            for name, p in self.model.named_parameters() if p in state
            and "exp_avg" in state[p])
    change = checks.leaf_norms((name, p.detach() - weights[name])
                               for name, p in self.model.named_parameters())
    return {"losses": [float(x) for x in losses], "grad_norms": grads,
            "change_norms": change, "outputs": outputs[0]}


def setup(cell):
  return State(cell)


class _Marks:
  """Step-end marks: CUDA events recorded on the stream (no synchronise),
  or host times off the card."""

  def __init__(self, device):
    self.cuda = torch.device(device).type == "cuda"
    self.marks = []

  def mark(self):
    if self.cuda:
      ev = torch.cuda.Event(enable_timing=True)
      ev.record()
      self.marks.append(ev)
    else:
      self.marks.append(time.perf_counter())

  def intervals_ms(self):
    m = self.marks
    if self.cuda:
      return [a.elapsed_time(b) for a, b in zip(m, m[1:])]
    return [(b - a) * 1e3 for a, b in zip(m, m[1:])]


def window(state, seconds, sync):
  """Steps until ``seconds`` of host time have passed, then a
  synchronise: {"units", "seconds", "host_s", "step_ms"}."""
  sync()
  marks = _Marks(state.cell.device)
  host = []
  marks.mark()
  t0 = time.perf_counter()
  while True:
    h0 = time.perf_counter()
    state.step()
    h1 = time.perf_counter()
    marks.mark()
    host.append(h1 - h0)
    if h1 - t0 >= seconds:
      break
  sync()
  win = {"units": len(host), "seconds": time.perf_counter() - t0,
         "host_s": host, "step_ms": marks.intervals_ms()}
  print(f"window: {win['units']} steps in {win['seconds']:.3f} s; host ms "
        f"a call median {1e3 * np.median(host):.3f}, step ms median "
        f"{np.median(win['step_ms']):.3f}, p95 "
        f"{np.percentile(win['step_ms'], 95):.3f}", file=sys.stderr)
  return win


def end_to_end(cell, win):
  return {"train_samples_per_s": (win["units"] * cell.traffic["batch"]
                                  / win["seconds"], "samples/s"),
          "train_step_p95_ms": (float(np.percentile(win["step_ms"], 95)),
                                "ms")}


def slice_work(state):
  """(the work a profiler slice records, the steps it takes)."""
  return (lambda: [state.step() for _ in range(SLICE_STEPS)]), SLICE_STEPS


def results(state):
  """What the check compares; frees the program's state."""
  out = state.checked
  del state.model, state.optimizer, state.pool
  return out


def reference(cell, tf32=False, transform=None):
  """The reference's readings of the checked steps, from the seed; with
  ``tf32`` in TF32 and with ``transform`` on each batch (the control and
  the faults, in the program's place)."""
  t, dev = cell.traffic, cell.device
  weights = inputs.make_weights(cell.cfg, cell.seed, dev)
  batches = inputs.make_batches(
      cell.cfg, [t["batch"]] * t["pool_batches"], cell.seed, dev,
      t["captions_per_video"])[:t["check_steps"]]
  batches = [transform(b) for b in batches] if transform else batches
  gen = inputs.generator(cell.seed, inputs.DROPOUT, dev)
  with ref_model.precision(tf32):
    ref = ref_train.train_steps(weights, cell.cfg, batches, gen)
  ref["outputs"] = checks.to_host(ref["outputs"])
  return ref


def numbers(prog, ref):
  return checks.train_numbers(prog, ref)
