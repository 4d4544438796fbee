"""The trainer's debug and observability switches (mmt_tpu_torch.train.
trainer, as mmt_tpu/train/trainer.py:185-194 reads them) on the CPU:
``debug_nans`` / MMT_TPU_DEBUG_NANS raise FloatingPointError at the first
NaN (the forward names its module, the backward its function), as the
JAX trainer with jax_debug_nans does on the same corpus; a clean run with
the switch on gives bitwise the losses and weights of the run without it
and leaves no hook and the anomaly mode as it was; MMT_TPU_PROFILE and
MMT_TPU_SANITY_CHECKS act as the ``profile_dir`` and ``sanity_checks``
keys.  One epoch of 2 steps on the tiny config of
tests/test_train_e2e.py.
"""

import json
import pathlib
import re
import sys

import numpy as np
import pytest
import torch

from mmt_tpu_torch import cli
from mmt_tpu_torch.data import synthetic
from mmt_tpu_torch.train import trainer as trainer_lib

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent))
from test_train_e2e import make_config  # noqa: E402

SWITCHES = ("MMT_TPU_DEBUG_NANS", "MMT_TPU_PROFILE", "MMT_TPU_SANITY_CHECKS")


def corpus(root, poisoned=False):
  """The tiny jsfusion corpus; ``poisoned``: one NaN in the first test
  video's rgb features (not at [0, 0], which the reader takes for a
  missing expert), which the epoch-0 eval reads first."""
  data_dir = synthetic.generate(root, num_videos=14, num_test=6,
                                experts={"rgb": 2048, "s3d": 1024},
                                captions_per_video=3)
  if poisoned:
    import h5py
    path = next((root / "vid_feat_files").rglob("video0000.h5"))
    with h5py.File(path, "r+") as f:
      feats = f["features.rgb"][()]
      feats[0, 1] = np.nan
      f["features.rgb"][...] = feats
  return data_dir


def write_config(root, name, data_dir, **trainer):
  cfg = make_config(root, data_dir, root / name)
  cfg["trainer"].update(epochs=1, max_samples_per_epoch=8, **trainer)
  path = root / f"{name}.json"
  path.write_text(json.dumps(cfg))
  return path


@pytest.fixture(scope="module")
def world(tmp_path_factory):
  """A clean corpus and a poisoned one, each with its vocab, and no
  switch in the environment."""
  root = tmp_path_factory.mktemp("switches")
  with pytest.MonkeyPatch.context() as mp:
    for name in SWITCHES:
      mp.delenv(name, raising=False)
    data = {"clean": corpus(root / "clean"),
            "nan": corpus(root / "nan", poisoned=True)}
    mp.setenv("MMT_TPU_BERT_VOCAB", str(root / "clean" / "vocab.txt"))
    yield root, data


def recorded(argv, monkeypatch):
  """cli.main(argv) with each step's loss recorded: (trainer, losses)."""
  losses, step = [], trainer_lib.train_step

  def recording(*args, **kw):
    loss = step(*args, **kw)
    losses.append(loss.detach().clone())
    return loss

  monkeypatch.setattr(trainer_lib, "train_step", recording)
  trainer = cli.main(argv)
  monkeypatch.setattr(trainer_lib, "train_step", step)
  return trainer, losses


@pytest.fixture(scope="module")
def runs(world):
  """The clean corpus's epoch without switches, then with debug_nans
  (the key), MMT_TPU_PROFILE and MMT_TPU_SANITY_CHECKS on, counting the
  batches validated."""
  from mmt_tpu_torch.utils import checks
  root, data = world
  out = {}
  with pytest.MonkeyPatch.context() as mp:
    out["plain"] = recorded(["--config", str(write_config(
        root, "plain", data["clean"])), "--device", "cpu"], mp)
    validated = []
    validate = checks.validate_batch
    mp.setattr(checks, "validate_batch",
               lambda batch: (validated.append(1), validate(batch)))
    mp.setenv("MMT_TPU_PROFILE", str(root / "profile"))
    mp.setenv("MMT_TPU_SANITY_CHECKS", "1")
    anomaly = (torch.is_anomaly_enabled(), torch.is_anomaly_check_nan_enabled())
    out["debug"] = recorded(["--config", str(write_config(
        root, "debug", data["clean"], debug_nans=True)), "--device", "cpu"],
        mp)
    out["anomaly"] = anomaly, (torch.is_anomaly_enabled(),
                               torch.is_anomaly_check_nan_enabled())
    out["validated"] = len(validated)
  return root, out


def test_a_clean_run_is_bitwise_the_same_with_debug_nans(runs):
  _, out = runs
  (plain, plain_losses), (debug, debug_losses) = out["plain"], out["debug"]
  assert debug.debug_nans and not plain.debug_nans
  assert len(plain_losses) == len(debug_losses) == 2
  for a, b in zip(plain_losses, debug_losses):
    assert torch.equal(a, b)
  want, got = plain.model.state_dict(), debug.model.state_dict()
  assert want.keys() == got.keys()
  for name in want:
    assert torch.equal(want[name], got[name]), name
  before, after = out["anomaly"]
  assert before == after
  assert all(not m._forward_hooks for m in debug.model.modules())


def test_profile_and_sanity_checks_from_the_environment(runs):
  root, out = runs
  debug, plain = out["debug"][0], out["plain"][0]
  assert debug.profile_dir == str(root / "profile")
  assert plain.profile_dir is None
  trace = json.loads((root / "profile" / "trace.json").read_text())
  assert any(str(e.get("name")).startswith("aten::")
             for e in trace["traceEvents"])
  # The program's spans: each of the epoch's 2 steps, and each wait for a
  # train batch (2, and the wait that found the loader's end).
  names = [e.get("name") for e in trace["traceEvents"]
           if e.get("cat") == "user_annotation"]
  assert names.count("mmt.step") == 2
  assert names.count("mmt.loader.wait") == 3
  assert debug.sanity_checks and not plain.sanity_checks
  assert out["validated"] == 1          # the one trained epoch's first batch


@pytest.mark.parametrize("switch", ["key", "env"])
def test_a_nan_feature_raises_naming_the_module(world, switch, monkeypatch):
  root, data = world
  trainer = dict(debug_nans=True) if switch == "key" else {}
  if switch == "env":
    monkeypatch.setenv("MMT_TPU_DEBUG_NANS", "1")
  cfg = write_config(root, f"nan_{switch}", data["nan"], **trainer)
  built = []
  build = cli.build_trainer
  monkeypatch.setattr(cli, "build_trainer",
                      lambda *a, **kw: built.append(build(*a, **kw))
                      or built[-1])
  with pytest.raises(FloatingPointError,
                     match=r"NaN in the output of module") as err:
    cli.main(["--config", str(cfg), "--device", "cpu"])
  name = re.search(r"module '([^']+)'", str(err.value)).group(1)
  modules = dict(built[0].model.named_modules())
  assert name in modules and name != ""
  assert not torch.is_anomaly_enabled()
  assert all(not m._forward_hooks for m in modules.values())


def test_without_the_switch_the_nan_runs_on(world, monkeypatch):
  """The poisoned corpus trains to the end without the switch: the
  switch is what raises."""
  root, data = world
  trainer = cli.main(["--config", str(write_config(root, "nan_off",
                                                   data["nan"])),
                      "--device", "cpu"])
  assert not trainer.debug_nans and trainer.n_steps == 2


def test_the_jax_trainer_raises_too(world):
  import jax
  import train as jax_cli
  root, data = world
  cfg = write_config(root, "nan_jax", data["nan"], debug_nans=True)
  try:
    with pytest.raises(FloatingPointError):
      jax_cli.main(["--config", str(cfg)])
  finally:
    jax.config.update("jax_debug_nans", False)


class NanGrad(torch.autograd.Function):
  """Identity forward, NaN gradient: a backward-only NaN."""

  @staticmethod
  def forward(ctx, x):
    return x.clone()

  @staticmethod
  def backward(ctx, grad):
    return grad * float("nan")


def test_a_nan_gradient_raises_naming_the_function():
  model = torch.nn.Linear(3, 2)
  before = torch.is_anomaly_enabled(), torch.is_anomaly_check_nan_enabled()
  with pytest.raises(FloatingPointError, match="NanGradBackward"):
    with trainer_lib.nan_trap(model):
      NanGrad.apply(model(torch.ones(4, 3))).sum().backward()
  assert (torch.is_anomaly_enabled(),
          torch.is_anomaly_check_nan_enabled()) == before
  assert not model._forward_hooks
  with trainer_lib.nan_trap(model, enabled=False):
    NanGrad.apply(model(torch.ones(4, 3))).sum().backward()
  assert torch.isnan(model.weight.grad).all()
