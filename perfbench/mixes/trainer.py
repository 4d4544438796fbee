"""The port's trainer at its loader: ``Trainer._train_epoch`` of
mmt_tpu_torch, built by ``cli.build_trainer`` from the configuration's
repository config, drives ``train_step`` from ``ExpertDataLoader`` (its
worker threads, the native assembler, random row picks, the device
prefetch) over a synthetic cut-c corpus that set-up writes from the seed
(``data/synthetic.py``) and the end of the run removes.

Traffic parameters: ``batch``, ``captions_per_video`` (of a sample),
``workers`` (the loader's), ``videos`` (of the corpus), ``max_feats``
(the corpus's most rows a video and expert; the loader picks
``max_expert_tokens`` of the configuration's at random), ``captions``
(a video's in the corpus), ``check_steps`` and ``slice_steps`` (the
steps of the profiled epoch).

Set-up runs the first epoch (the whole corpus); its first
``check_steps`` steps are the checked ones: each batch as the loader
delivered it, the first step's tower outputs and gradient norms, the
change of every leaf after them, and each step's similarity as the
program's loss got it (the trainer's loss function wrapped for those
steps in a copy to one buffer, which the step's CUDA graph keeps; the
wrapper is taken off after them, so the trainer captures its step anew
before the window).  The reference then trains from the same initial
weights and dropout stream on those very batches, counting each hinge
term of the loss where the program's similarity counts it
(``reference/hinge.py`` says why), and reports ``hinge_gap``.  The window
runs whole epochs until its seconds have passed, marking the end of
every step as ``mixes/train.py`` does (epoch boundaries, the loader's
restart, count).
"""

from __future__ import annotations

import contextlib
import json
import os
import pathlib
import shutil
import signal
import sys
import tempfile
import time

import numpy as np
import torch

from perfbench import checks, flops
from perfbench.mixes import train as train_mix
from perfbench.reference import hinge as ref_hinge
from perfbench.reference import model as ref_model

KIND = "trainer"
CHECKOUT = pathlib.Path(__file__).resolve().parents[2]
BERT_VOCAB = 28996   # bert-base-cased's table, the configuration's text vocab


def unit_flops(cell):
  t = cell.traffic
  return flops.train_step_flops(cell.cfg, t["batch"], t["captions_per_video"])


def ffn_calls(cell):
  t = cell.traffic
  return flops.ffn_calls_train_step(cell.cfg, t["batch"],
                                    t["captions_per_video"])


def trainer_config(cell, data_dir, save_dir):
  """The repository config with the corpus, the cut-c splits, the
  loader's workers and the seed set; an epoch is the whole corpus."""
  raw = json.loads((CHECKOUT / cell.cfg["repo_config"]).read_text())
  t = cell.traffic
  for key, split in (("train_sets", "trainval"),
                     ("continuous_eval_sets", "val"),
                     ("final_eval_sets", "val")):
    entry = raw[key][0]
    raw[key] = [entry]
    entry["args"].update(batch_size=t["batch"])
    mix = entry["args"]["mix"][0]
    mix.update(data_dir=str(data_dir), cut_name="c", split_name=split,
               max_expert_tokens=cell.cfg["max_expert_tokens"],
               max_text_words=cell.cfg["max_text_words"])
    if key == "train_sets":
      entry["args"]["num_workers"] = t["workers"]
    else:
      entry["args"]["num_workers"] = 0
      mix["captions_per_video"] = 1
  raw["seed"] = cell.seed % 2 ** 31
  raw["exp_name"] = "perfbench"
  raw["trainer"].update(save_dir=str(save_dir), epochs=1,
                        max_samples_per_epoch=t["videos"])
  raw.pop("visualizer", None)
  return raw


class State:
  """The trainer the set-up builds and the window drives, with the corpus
  and the environment it needs."""

  def __init__(self, cell):
    from mmt_tpu_torch import bench_sustained, cli
    from mmt_tpu_torch import config as config_lib
    from mmt_tpu_torch.data import synthetic
    from mmt_tpu_torch.train import trainer as trainer_lib

    self.cell, t = cell, cell.traffic
    self.root = pathlib.Path(tempfile.mkdtemp(prefix="perfbench_trainer_"))
    self.shims = contextlib.ExitStack()
    self.shims.callback(shutil.rmtree, self.root, ignore_errors=True)
    dims = {m: e["dim"] for m, e in cell.cfg["experts"].items()}
    tic = time.perf_counter()
    data_dir = synthetic.generate(
        self.root, num_videos=t["videos"] + t["batch"], num_test=t["batch"],
        experts=dims, captions_per_video=t["captions"],
        max_feats=t["max_feats"], seed=cell.seed % 2 ** 32, cut="c")
    vocab = (self.root / "vocab.txt").read_text().splitlines()
    vocab += [f"[unused{i}]" for i in range(BERT_VOCAB - len(vocab))]
    (self.root / "vocab.txt").write_text("\n".join(vocab) + "\n")
    size = sum(p.stat().st_size for p in data_dir.rglob("*"))
    print(f"corpus: {t['videos']} train videos, {size / 2 ** 30:.3f} GiB in "
          f"{time.perf_counter() - tic:.1f} s", file=sys.stderr)
    self.shims.enter_context(_environ("MMT_TPU_BERT_VOCAB",
                                      str(self.root / "vocab.txt")))
    self.shims.enter_context(bench_sustained.flagship_expert_names(dims))
    prev_sigterm = signal.getsignal(signal.SIGTERM)
    self.shims.callback(signal.signal, signal.SIGTERM, prev_sigterm)
    config = config_lib.Config(trainer_config(cell, data_dir,
                                              self.root / "exp"))
    config.prepare_dirs()
    self.trainer = cli.build_trainer(config, device=cell.device)
    model = self.trainer.model
    self.start = {n: v.detach().to("cpu", copy=True)
                  for n, v in model.state_dict().items()}
    self.generator = self.trainer.generator.get_state()
    # The trainer's calls of train_step, through this recorder.
    self.real_step = trainer_lib.train_step
    self.shims.callback(setattr, trainer_lib, "train_step", self.real_step)
    trainer_lib.train_step = self.record
    self.marks, self.host, self.batches, self.sims = None, [], [], []
    self.outputs, self.losses, self.grads, self.change = [], [], None, None
    self.loss_fn = self.trainer.loss_fn
    self.recorder = _Recorder(self.loss_fn)
    self.trainer.loss_fn = self.recorder
    self.epoch = 1
    self.hook = model.register_forward_hook(
        lambda mod, args, out: self.outputs.append(checks.to_host(out)))
    self.trainer._train_epoch(self.epoch)

  def record(self, model, optimizer, batch, **kw):
    """``train_step`` for the trainer: the checked steps' readings, then
    each step's host seconds and end mark."""
    n = len(self.losses)
    checked = n < self.cell.traffic["check_steps"]
    if checked:
      self.batches.append(_to_host(batch))
    h0 = time.perf_counter()
    loss = self.real_step(model, optimizer, batch, **kw)
    h1 = time.perf_counter()
    if self.marks is not None:
      self.marks.mark()
      self.host.append(h1 - h0)
    if checked:
      self.sims.append(self.recorder.sims.to("cpu", copy=True))
      self.losses.append(float(loss))
      if n == 0:
        self.hook.remove()
        beta1 = optimizer.param_groups[0]["betas"][0]
        state = optimizer.state
        self.grads = checks.leaf_norms(
            (name, state[p]["exp_avg"] / (1 - beta1))
            for name, p in model.named_parameters() if p in state)
      if n + 1 == self.cell.traffic["check_steps"]:
        self.trainer.loss_fn = self.loss_fn
        self.change = checks.leaf_norms(
            (name, p.detach() - self.start[name].to(p.device))
            for name, p in model.named_parameters())
    return loss

  def epochs(self, until):
    """Whole epochs until ``until()`` is true; returns the steps run."""
    steps = self.trainer.n_steps
    while True:
      self.epoch += 1
      self.trainer._train_epoch(self.epoch)
      if until():
        return self.trainer.n_steps - steps


class _Recorder:
  """The trainer's loss function, also copying each similarity it is
  given into one buffer, ``sims`` (made at the first call)."""

  def __init__(self, loss_fn):
    self.loss_fn, self.sims = loss_fn, None

  def __call__(self, x):
    if self.sims is None:
      self.sims = torch.empty_like(x.detach())
    self.sims.copy_(x.detach())
    return self.loss_fn(x)


@contextlib.contextmanager
def _environ(name, value):
  prev = os.environ.get(name)
  os.environ[name] = value
  try:
    yield
  finally:
    if prev is None:
      os.environ.pop(name, None)
    else:
      os.environ[name] = prev


def _to_host(batch):
  if isinstance(batch, dict):
    return {k: _to_host(v) for k, v in batch.items()}
  return batch.detach().to("cpu", copy=True)


def _to_device(batch, device):
  if isinstance(batch, dict):
    return {k: _to_device(v, device) for k, v in batch.items()}
  return batch.to(device)


def setup(cell):
  return State(cell)


def window(state, seconds, sync):
  """Whole epochs until ``seconds`` of host time have passed, then a
  synchronise: {"units", "seconds", "host_s", "step_ms"}."""
  sync()
  state.marks, state.host = train_mix._Marks(state.cell.device), []
  state.marks.mark()
  t0 = time.perf_counter()
  units = state.epochs(lambda: time.perf_counter() - t0 >= seconds)
  sync()
  win = {"units": units, "seconds": time.perf_counter() - t0,
         "host_s": state.host, "step_ms": state.marks.intervals_ms()}
  state.marks = None
  print(f"window: {units} steps in {win['seconds']:.3f} s ({state.epoch - 1}"
        f" epochs); step ms median {np.median(win['step_ms']):.3f}, p95 "
        f"{np.percentile(win['step_ms'], 95):.3f}", file=sys.stderr)
  return win


def end_to_end(cell, win):
  return train_mix.end_to_end(cell, win)


def slice_work(state):
  """(one epoch of ``slice_steps`` steps, its steps)."""
  n = state.cell.traffic["slice_steps"]
  t = state.trainer

  def work():
    full = t.max_samples_per_epoch
    t.max_samples_per_epoch = n * state.cell.traffic["batch"]
    try:
      state.epochs(lambda: True)
    finally:
      t.max_samples_per_epoch = full

  return work, n


def results(state):
  """What the check compares; the batches and the start go to the cell
  for the reference, and the program's similarities too, for it to
  follow.  Frees the trainer, restores the environment and removes the
  corpus."""
  out = {"losses": state.losses, "grad_norms": state.grads,
         "change_norms": state.change, "outputs": state.outputs[0]}
  state.cell.trainer_start = (state.start, state.generator, state.batches)
  state.cell.program_sims = state.sims
  del state.trainer
  state.shims.close()
  return out


def reference(cell, tf32=False, transform=None):
  """The reference's readings of the checked steps, from the weights and
  dropout stream the trainer started from, on the batches the loader
  delivered (with ``transform`` on each), each hinge term counted where
  what ran in the program's place counted it: the program, or the first
  reference run, such as the control's, which counts on its own (where
  the batches keep their size; "hinge_gap" is left out otherwise).  In
  TF32 with ``tf32``.  With no run of the cell before it (the control),
  it runs the set-up first for the batches and the start."""
  if getattr(cell, "trainer_start", None) is None:
    results(setup(cell))
    cell.program_sims = None
    torch.cuda.empty_cache()
  params, gen_state, host_batches = cell.trainer_start
  sims = cell.program_sims
  dev = cell.device
  gen = torch.Generator(device=dev)
  gen.set_state(gen_state)
  batches = [_to_device(b, dev) for b in host_batches]
  batches = [transform(b) for b in batches] if transform else batches
  sizes = [len(b["token_ids"]) for b in batches]
  fit = sims is not None and all(len(s) == n for s, n in zip(sims, sizes))
  with ref_model.precision(tf32):
    ref = ref_hinge.train_steps({n: v.to(dev) for n, v in params.items()},
                                cell.cfg, batches, gen, sims if fit else None)
  ref["outputs"] = checks.to_host(ref["outputs"])
  if sims is None:
    cell.program_sims = ref["sims"]
  return ref


def numbers(prog, ref):
  """``checks.train_numbers`` and ``hinge_gap``, the reading of the
  reference that followed the program's hinge terms (infinite where it
  could not follow them, as under the half-batch fault)."""
  return {**checks.train_numbers(prog, ref),
          "hinge_gap": ref.get("hinge_gap", float("inf"))}
