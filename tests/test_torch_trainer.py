"""The port's checkpoints, trainer and CLI (mmt_tpu_torch.train.checkpoint,
train.trainer, cli) on the CPU, against the JAX package's.

A mirror of tests/test_train_e2e.py through the port's CLI, the
checkpoint rules one by one, and a whole-run parity test: the same config
(every dropout rate 0) trained 2 epochs by the JAX CLI's functions and by
``mmt_tpu_torch.cli`` from the same initial weights (the JAX trainer's
init through ``convert.state_dict_from_flax``).
"""

import argparse
import inspect
import json
import os
import pathlib
import signal
import subprocess
import sys
import threading

import numpy as np
import pytest
import torch

from mmt_tpu_torch import cli, convert
from mmt_tpu_torch.data import synthetic
from mmt_tpu_torch.ops import ranking
from mmt_tpu_torch.train import checkpoint as ckpt_lib
from mmt_tpu_torch.train.trainer import Trainer

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent))
from test_train_e2e import make_config  # noqa: E402

REPO = pathlib.Path(__file__).resolve().parent.parent
DS = "MSRVTT_jsfusion_test"
# Whole-run parity tolerances: each epoch's mean loss (relative), the
# final sims (absolute); metrics must be equal wherever no two sims of a
# query lie within SIMS_TOL.
LOSS_RTOL, SIMS_TOL = 1e-4, 1e-4


@pytest.fixture(scope="module")
def workspace(tmp_path_factory):
  root = tmp_path_factory.mktemp("torch_e2e")
  data_dir = synthetic.generate(root, num_videos=14, num_test=6,
                                experts={"rgb": 2048, "s3d": 1024},
                                captions_per_video=3)
  os.environ["MMT_TPU_BERT_VOCAB"] = str(root / "vocab.txt")
  return root, data_dir


def write_config(root, name, cfg):
  path = root / f"{name}.json"
  path.write_text(json.dumps(cfg))
  return path


@pytest.fixture(scope="module")
def trained(workspace, tmp_path_factory):
  """Train once through the port's CLI; several tests inspect the run."""
  root, data_dir = workspace
  exp_root = tmp_path_factory.mktemp("torch_exps") / "tiny"
  cfg_path = write_config(root, "tiny_config",
                          make_config(root, data_dir, exp_root))
  trainer = cli.main(["--config", str(cfg_path), "--device", "cpu"])
  return trainer, exp_root, cfg_path, root, data_dir


def results(exp_dir):
  with open(pathlib.Path(exp_dir) / "exp_results.json") as f:
    return json.load(f)["perfs"][DS]


def test_training_runs_and_saves(trained):
  trainer, exp_root, *_ = trained
  for name in ("config.json", "log.txt", "trained_model.pth",
               "exp_results.json", "exp_completed_flag.txt", "perf_log.txt",
               "MSRVTT-test-sims.npy"):
    assert (exp_root / name).exists(), name
  sims = np.load(exp_root / "MSRVTT-test-sims.npy", allow_pickle=True)[()]
  assert sims["sims"].shape == (6, 6) and np.isfinite(sims["sims"]).all()
  assert trainer.n_steps == 8 and trainer.n_samples == 32


def test_metrics_recorded(trained):
  perfs = results(trained[1])
  assert 0 <= perfs["t2v_metrics/R1/final_eval"] <= 100
  assert 0 <= perfs["v2t_metrics/R1/final_eval"] <= 100


def test_checkpoint_purge(trained):
  trainer, exp_root, *_ = trained
  ckpts = sorted(exp_root.glob("checkpoint-epoch*.pth"))
  assert [p.name for p in ckpts] == ["checkpoint-epoch2.pth"]
  assert len(ckpts) <= trainer.num_keep_ckpts


def test_visualizer_output(trained):
  pages = list((trained[1] / "visualisations").rglob("*.html"))
  assert pages, "expected HTML ranking pages"


def test_loss_finite_and_logged(trained):
  exp_root = trained[1]
  with open(exp_root / "perf_log.txt") as f:
    log = [json.loads(line) for line in f]
  assert [e["epoch"] for e in log] == [0, 1, 2]
  assert [e["n_steps"] for e in log] == [0, 4, 8]
  losses = [e["loss"] for e in log[1:]]
  assert all(np.isfinite(x) and x > 0 for x in losses)
  # Each trained epoch times its steps (on the card by CUDA events, here
  # as they ran) and the host's enqueue of them.
  for e in log[1:]:
    assert e["timer.train_batch.step.sum"] > 0
    assert e["timer.train_batch.dispatch.sum"] > 0


def test_only_eval_warm_start(trained):
  """--only_eval --load_checkpoint reproduces the eval without training
  (warm-start path, base/base_trainer.py:452-462)."""
  trainer, exp_root, cfg_path, root, data_dir = trained
  cfg_path2 = write_config(root, "tiny_eval", make_config(
      root, data_dir, exp_root.parent / "tiny_eval"))
  cli.main(["--config", str(cfg_path2), "--only_eval", "--device", "cpu",
            "--load_checkpoint", str(exp_root / "trained_model.pth")])
  assert results(exp_root.parent / "tiny_eval") == results(exp_root)
  assert (exp_root.parent / "tiny_eval" / "info_checkpoint.txt").exists()


def test_only_eval_resume(trained):
  """--only_eval --resume evaluates the experiment's own best weights."""
  trainer, exp_root, *_ = trained
  before = results(exp_root)
  t2 = cli.main(["--resume", str(exp_root), "--only_eval",
                 "--device", "cpu"])
  assert results(exp_root) == before
  assert t2.loaded_epoch == 2 and t2.n_steps == trainer.n_steps


def test_resume_restores_counters_and_generator(trained):
  """A restart restores the counters AND the dropout generator's state
  (the stream continues exactly; the reference loses it across
  --resume)."""
  trainer, exp_root, *_ = trained
  t2 = cli.main(["--resume", str(exp_root), "--device", "cpu"])
  assert t2.start_epoch == trainer.epoch + 1 == 3
  assert (t2.n_steps, t2.n_samples) == (trainer.n_steps, trainer.n_samples)
  assert torch.equal(t2.generator.get_state(), trainer.generator.get_state())
  state = ckpt_lib.load_checkpoint(exp_root / "trained_model.pth")
  assert torch.equal(t2.generator.get_state(), state["generator"])
  for k, v in state["optimizer"]["state"].items():
    got = t2.optimizer.state_dict()["state"][k]
    assert all(torch.equal(got[n], v[n]) for n in v)


def test_fused_eval_matches_matrix_path(trained):
  """Continuous eval through the fused no-matrix ranking path produces
  the same metrics as the materialized-similarity path."""
  trainer = trained[0]
  old, vis = trainer.fused_eval_from_videos, trainer.visualizer
  try:
    trainer.visualizer = None
    trainer.fused_eval_from_videos = 0
    res_matrix = trainer._valid_epoch(epoch=0, sets="continuous_eval")
    trainer.fused_eval_from_videos = 1   # force the fused path
    res_fused = trainer._valid_epoch(epoch=0, sets="continuous_eval")
  finally:
    trainer.fused_eval_from_videos, trainer.visualizer = old, vis
  for ds, nested in res_matrix["metrics"].items():
    for metric_name, vals in nested.items():
      for key in ("R1", "R5", "R10", "MedR", "MeanR"):
        np.testing.assert_allclose(
            res_fused["metrics"][ds][metric_name][key], vals[key],
            err_msg=f"{ds}/{metric_name}/{key}")


def test_preemption_defers_and_stamps_completed_epoch(trained):
  """SIGTERM only sets a flag; _maybe_preempt_exit then checkpoints
  stamped with the last COMPLETED epoch so restart re-runs the
  interrupted one."""
  trainer = trained[0]
  trainer._install_preemption_handler()
  handler = signal.getsignal(signal.SIGTERM)
  assert callable(handler)
  trainer._preempt_requested = False
  handler(signal.SIGTERM, None)          # must NOT raise or save
  assert trainer._preempt_requested

  with pytest.raises(SystemExit) as exc:
    trainer._maybe_preempt_exit(1)       # mid-epoch-2: epoch 1 completed
  assert exc.value.code == 143
  path = pathlib.Path(trainer.exp_dir) / "checkpoint-epoch1.pth"
  assert path.exists()
  assert int(ckpt_lib.load_checkpoint(path)["epoch"]) == 1
  trainer._preempt_requested = False
  trainer._maybe_preempt_exit(1)         # no request -> returns quietly


def test_monitor_key_validated_at_startup(trained):
  """A monitor string the epoch log can never contain raises at Trainer
  construction; valid metric keys are accepted."""
  trainer, exp_root, cfg_path, root, data_dir = trained
  cfg = json.loads(cfg_path.read_text())
  good = dict(cfg, trainer={**cfg["trainer"],
                            "monitor": f"max {DS}/t2v_metrics/R1",
                            "epochs": 1, "max_samples_per_epoch": 4,
                            "save_dir": str(exp_root / "mon_good")})
  cli.main(["--config", str(write_config(root, "mon_good", good)),
            "--device", "cpu"])
  assert (exp_root / "mon_good" / "trained_model.pth").exists()
  bad = dict(cfg, trainer={**cfg["trainer"],
                           "monitor": f"max {DS}/t2v_metrics/R2",
                           "save_dir": str(exp_root / "mon_bad")})
  with pytest.raises(ValueError, match="will never appear"):
    cli.main(["--config", str(write_config(root, "mon_bad", bad)),
              "--device", "cpu"])


@pytest.fixture(scope="module")
def switched(workspace, tmp_path_factory):
  """One trained epoch with the trainer's optional switches on
  (sanity_checks, profile_dir, async_checkpoint false), recording the
  batches validated and the threads that wrote checkpoints."""
  from mmt_tpu_torch.utils import checks
  root, data_dir = workspace
  out = tmp_path_factory.mktemp("torch_switches")
  cfg = make_config(root, data_dir, out / "exp")
  cfg["trainer"].update(epochs=1, max_samples_per_epoch=8,
                        sanity_checks=True, async_checkpoint=False,
                        profile_dir=str(out / "profile"))
  seen = {"validated": 0, "writers": []}
  validate, save = checks.validate_batch, ckpt_lib.save_checkpoint

  def counted_validate(batch):
    seen["validated"] += 1
    validate(batch)

  def recorded_save(*args, **kwargs):
    seen["writers"].append(threading.current_thread().name)
    return save(*args, **kwargs)

  with pytest.MonkeyPatch.context() as mp:
    mp.setattr(checks, "validate_batch", counted_validate)
    mp.setattr(ckpt_lib, "save_checkpoint", recorded_save)
    trainer = cli.main(["--config", str(write_config(root, "switched", cfg)),
                        "--device", "cpu"])
  return trainer, out, seen


def test_sanity_checks_validate_each_epochs_first_batch(switched):
  trainer, out, seen = switched
  assert trainer.sanity_checks and trainer.n_steps == 2
  assert seen["validated"] == 1          # one trained epoch
  bad = {"token_ids": np.zeros((2, 3, 2), np.int64)}   # no valid token
  with pytest.raises(ValueError, match="zero valid tokens"):
    next(trainer._checked(iter([bad])))


def test_profile_dir_traces_the_first_trained_epoch(switched):
  _, out, _ = switched
  trace = json.loads((out / "profile" / "trace.json").read_text())
  names = {e.get("name") for e in trace["traceEvents"]}
  assert any(str(n).startswith("aten::") for n in names)


def test_async_checkpoint_false_writes_inline(switched):
  trainer, out, seen = switched
  assert trainer._ckpt_writer._pool is None
  assert seen["writers"] and set(seen["writers"]) == {"MainThread"}
  assert (out / "exp" / "checkpoint-epoch1.pth").exists()


def test_cli_runs_as_a_module_and_imports_no_jax(trained):
  """``python -m mmt_tpu_torch.train`` on the CPU: evaluates a warm
  start and pulls in no jax, jaxlib, flax, optax or mmt_tpu module."""
  trainer, exp_root, cfg_path, root, data_dir = trained
  out = exp_root.parent / "as_module"
  cfg = write_config(root, "as_module", make_config(root, data_dir, out))
  code = (
      "import runpy, sys\n"
      "before = set(sys.modules)\n"
      f"sys.argv = ['train', '--config', {str(cfg)!r}, '--only_eval',\n"
      f"            '--device', 'cpu', '--load_checkpoint',\n"
      f"            {str(exp_root / 'trained_model.pth')!r}]\n"
      "runpy.run_module('mmt_tpu_torch.train', run_name='__main__')\n"
      "new = set(sys.modules) - before\n"
      "bad = sorted(m for m in new if m.split('.')[0] in\n"
      "             ('jax', 'jaxlib', 'flax', 'optax', 'mmt_tpu'))\n"
      "print('BAD', bad)\n"
      "assert not bad, bad\n")
  proc = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                        capture_output=True, text=True, timeout=300,
                        env=dict(os.environ))
  assert proc.returncode == 0, proc.stdout[-3000:] + proc.stderr[-3000:]
  assert "BAD []" in proc.stdout
  assert results(out) == results(exp_root)


def test_cli_and_trainer_default_to_the_card(trained):
  trainer, exp_root, cfg_path, root, data_dir = trained
  assert inspect.signature(Trainer).parameters["device"].default == "cuda"
  assert inspect.signature(cli.build_trainer).parameters[
      "device"].default == "cuda"
  if torch.cuda.is_available():
    pytest.skip("a card is present: the CUDA default runs in chip_smoke.py")
  cfg = write_config(root, "no_card", make_config(
      root, data_dir, exp_root.parent / "no_card"))
  with pytest.raises(RuntimeError, match="no CUDA device"):
    cli.main(["--config", str(cfg)])
  assert not (exp_root.parent / "no_card").exists()


def test_flagship_config_builds_the_port_cenet(tmp_path):
  """The flagship config's arch.args (l2renorm included) build the port's
  CENet: sorted modalities and 1 + 7 x (1 + 30) video tokens (the
  flagship's widths cut to test size; what K1's JAX test meant to
  show)."""
  from mmt_tpu_torch import config as port_config
  from mmt_tpu_torch.experts import compute_dims
  from mmt_tpu_torch.flagship import batch_to_torch, make_batch
  from mmt_tpu_torch.models.cenet import CENet, cenet_kwargs_from_arch_args

  cfg = port_config.load(REPO / "configs" / "eccv20" /
                         "msrvtt_jsfusion_trainval.json")
  args = dict(cfg.arch_args, compute_dtype="bfloat16")
  kwargs, init = cenet_kwargs_from_arch_args(args, tokenizer=None)
  assert init is None and kwargs["compute_dtype"] is torch.bfloat16
  assert kwargs["l2renorm"] is False
  kwargs["compute_dtype"] = torch.float32
  kwargs["vid_bert_params"] = dict(kwargs["vid_bert_params"], hidden_size=32,
                                   intermediate_size=64)
  dims = compute_dims(cfg.raw)
  model = CENet(expert_dims=dims, device="cpu", same_dim=32,
                text_bert_geometry=dict(hidden_size=32, num_hidden_layers=1,
                                        num_attention_heads=4,
                                        intermediate_size=64, vocab_size=64),
                **{k: v for k, v in kwargs.items() if k != "same_dim"})
  assert model.modalities == sorted(cfg["experts"]["modalities"])
  batch = batch_to_torch(make_batch(dims, 2, vocab=64), "cpu")
  seq = model._assemble_video_sequence(
      batch, 2, torch.zeros(2, 7, 32),
      [torch.zeros(2, 30, 32) for _ in model.modalities])
  assert seq[0].shape == (2, 1 + 7 * (1 + 30), 32)
  # l2renorm is inert, as in the JAX package and the reference: stored.
  assert CENet(expert_dims=dims, vid_bert_params=kwargs["vid_bert_params"],
               same_dim=32, device="cpu", l2renorm=True).l2renorm is True
  with pytest.raises(ValueError, match="compute_dtype"):
    cenet_kwargs_from_arch_args(dict(args, compute_dtype="fp8"), None)


# ---------------------------------------------------------------------------
# Checkpoint rules
# ---------------------------------------------------------------------------


def tiny_model(seed=0):
  from mmt_tpu_torch import flagship
  return flagship.flagship_model(device="cpu", tiny=True, seed=seed,
                                 compute_dtype=torch.float32)


def test_checkpoint_round_trip(tmp_path):
  model = tiny_model()
  bn = model.text_GU["rgb"].cg.batch_norm
  bn.running_mean.fill_(0.25)
  bn.num_batches_tracked.fill_(3)
  opt = torch.optim.Adam(model.parameters(), lr=1e-3)
  for p in model.parameters():
    p.grad = torch.ones_like(p)
  opt.step()
  gen = torch.Generator().manual_seed(5)
  torch.rand(3, generator=gen)
  state = ckpt_lib.to_host({"state_dict": model.state_dict(),
                            "optimizer": opt.state_dict(), "epoch": 4,
                            "generator": gen.get_state(), "config": "{}"})
  path = ckpt_lib.save_checkpoint(tmp_path, state, 4, save_best=True)
  assert path.endswith("checkpoint-epoch4.pth")
  assert ((tmp_path / "trained_model.pth").read_bytes()
          == pathlib.Path(path).read_bytes())
  assert not list(tmp_path.glob("*_tmp"))
  raw = ckpt_lib.load_checkpoint(path)
  fresh = tiny_model(seed=1)
  fresh.load_state_dict(raw["state_dict"], strict=True)
  for k, v in model.state_dict().items():
    assert torch.equal(fresh.state_dict()[k], v), k
  opt2 = torch.optim.Adam(fresh.parameters(), lr=1e-3)
  opt2.load_state_dict(raw["optimizer"])
  assert opt2.state_dict()["state"][0]["step"] == 1
  gen2 = torch.Generator().set_state(raw["generator"])
  assert torch.equal(torch.rand(3, generator=gen2), torch.rand(3, generator=gen))
  assert raw["epoch"] == 4


@pytest.mark.parametrize("async_enabled", (True, False))
def test_async_writer_keeps_order_and_surfaces_errors(tmp_path, async_enabled):
  writer = ckpt_lib.AsyncCheckpointWriter(async_enabled=async_enabled)
  for epoch in (1, 2, 3):
    writer.save(tmp_path, {"epoch": epoch}, epoch, save_best=epoch == 2)
    # A purge submitted after a save always sees the save's file.
    writer.purge(tmp_path, num_keep=1)
  writer.flush()
  assert [p.name for p in tmp_path.glob("checkpoint-epoch*.pth")] == [
      "checkpoint-epoch3.pth"]
  assert ckpt_lib.load_checkpoint(tmp_path / "trained_model.pth")["epoch"] == 2

  blocker = tmp_path / "not_a_dir"
  blocker.write_text("x")
  if async_enabled:
    writer.save(blocker, {"epoch": 9}, 9)         # fails on the worker
    with pytest.raises((FileExistsError, NotADirectoryError)):
      writer.flush()
    writer.flush()                                # the error is reported once
  else:
    with pytest.raises((FileExistsError, NotADirectoryError)):
      writer.save(blocker, {"epoch": 9}, 9)


def test_purge_keeps_the_newest_and_last_checkpoint_finds_pth(tmp_path):
  """The purge deletes stale .pth files only; auto-resume takes the
  highest epoch of either suffix, the .pth at equal epochs."""
  for epoch in (1, 3, 10, 2):
    (tmp_path / f"checkpoint-epoch{epoch}.pth").write_bytes(b"x")
  for epoch in (9, 10):
    (tmp_path / f"checkpoint-epoch{epoch}.msgpack").write_bytes(b"x")
  (tmp_path / "trained_model.pth").write_bytes(b"x")
  assert ckpt_lib.last_checkpoint(tmp_path).endswith("checkpoint-epoch10.pth")
  ckpt_lib.purge_stale_checkpoints(tmp_path, num_keep=2)
  left = sorted(p.name for p in tmp_path.iterdir())
  assert left == ["checkpoint-epoch10.msgpack", "checkpoint-epoch10.pth",
                  "checkpoint-epoch3.pth", "checkpoint-epoch9.msgpack",
                  "trained_model.pth"]
  assert ckpt_lib.last_checkpoint(tmp_path / "missing") is None


def test_zero_pad_rule_and_non_strict_merge():
  target = tiny_model().state_dict()
  name = ckpt_lib.POS_EMB
  rows, width = target[name].shape
  short = torch.randn(rows - 5, width)
  loaded = ckpt_lib.match_checkpoint_to_model(
      {name: short, "extra": torch.ones(2)}, target)
  assert loaded[name].shape == target[name].shape
  assert torch.equal(loaded[name][:rows - 5], short)
  assert not loaded[name][rows - 5:].any()
  stats = {}
  wrong = next(k for k in target if k.endswith("query.weight"))
  merged = ckpt_lib.merge_params(
      target, dict(loaded, **{wrong: torch.zeros(3, 3)}), stats=stats)
  assert stats["matched"] == 1 and torch.equal(merged[name], loaded[name])
  assert wrong in stats["skipped"] and torch.equal(merged[wrong], target[wrong])
  assert len(stats["skipped"]) == len(target) - 1
  assert set(merged) == set(target)


# ---------------------------------------------------------------------------
# Whole-run parity with the JAX CLI
# ---------------------------------------------------------------------------


# The text tower's initializer_range in the parity config; the config's
# own 0.02 is the conditioning case below.
PARITY_INIT_RANGE, CONFIG_INIT_RANGE = 0.5, 0.02


def parity_config(root, data_dir, exp_dir, init_range=PARITY_INIT_RANGE,
                  seed=0):
  """The e2e config with every dropout rate 0 and the text tower drawn at
  ``init_range`` (0.5).  At the config's 0.02 the random text tower gives
  nearly the same CLS for every synthetic caption, so the batch variance
  of the train-mode BatchNorm's gate is as small as fp32's error in
  mean(g^2) - mean^2: the port against itself from initial weights moved
  by one rounding differs beyond these tolerances, and so does the JAX
  CLI (test_parity_gap_at_the_configs_range_is_rounding_sized)."""
  cfg = make_config(root, data_dir, exp_dir, seed=seed)
  args = cfg["arch"]["args"]
  for tower in ("vid_bert_params", "txt_bert_params"):
    args[tower]["hidden_dropout_prob"] = 0.0
    args[tower]["attention_probs_dropout_prob"] = 0.0
  args["text_bert_geometry"]["initializer_range"] = init_range
  return cfg


def jax_and_port_runs(workspace, exps, init_range, seed=0):
  """Train 2 epochs with the JAX CLI's functions and with the port's CLI
  from the JAX trainer's initial weights (saved as exps/init.pth)."""
  import jax
  import train as jax_cli
  from mmt_tpu import config as jax_config

  root, data_dir = workspace
  jax_path = write_config(exps, "jax", parity_config(
      root, data_dir, exps / "jax", init_range, seed))
  ns = argparse.Namespace(config=str(jax_path), resume=None,
                          load_checkpoint=None, only_eval=False,
                          txt_bert_init=None)
  jax_trainer = jax_cli.build_trainer(jax_config.from_args(ns))
  to_np = lambda tree: jax.tree_util.tree_map(np.asarray, tree)
  init = convert.state_dict_from_flax(to_np(jax_trainer.params),
                                      to_np(jax_trainer.batch_stats))
  torch.save({"state_dict": init}, exps / "init.pth")
  jax_trainer.train()
  jax_trainer.evaluate()
  port_trainer = port_run(workspace, exps, "port", init, init_range, seed)
  return jax_trainer, port_trainer, init


def port_run(workspace, exps, name, state_dict, init_range, seed=0):
  """The port's CLI, 2 epochs of the parity config from ``state_dict``."""
  root, data_dir = workspace
  torch.save({"state_dict": state_dict}, exps / f"{name}.pth")
  path = write_config(exps, name, parity_config(
      root, data_dir, exps / name, init_range, seed))
  return cli.main(["--config", str(path), "--device", "cpu",
                   "--load_checkpoint", str(exps / f"{name}.pth")])


def moved_by_one_rounding(state_dict, draw):
  """Each floating weight times 1 + u, |u| <= 2^-24, u drawn from a
  generator seeded with 100 + draw."""
  gen = torch.Generator().manual_seed(100 + draw)
  nudge = lambda v: v * (1 + (torch.rand(v.shape, generator=gen) * 2 - 1)
                         * 2.0 ** -24)
  return {k: nudge(v) if v.is_floating_point() else v
          for k, v in state_dict.items()}


@pytest.fixture(scope="module")
def parity(workspace, tmp_path_factory):
  exps = tmp_path_factory.mktemp("parity")
  jax_trainer, port_trainer, init = jax_and_port_runs(
      workspace, exps, PARITY_INIT_RANGE)
  return jax_trainer, port_trainer, exps, init


def _epoch_losses(exp_dir):
  with open(exp_dir / "perf_log.txt") as f:
    return [json.loads(line)["loss"] for line in f]


def _sims(exp_dir):
  return np.load(exp_dir / "MSRVTT-test-sims.npy", allow_pickle=True)[()]


def test_jax_trainer_params_load_strict(parity):
  """The JAX trainer's params, converted, load strict into the CENet the
  port's CLI built from the same config, before and after training."""
  jax_trainer, port_trainer, exps, init = parity
  port_trainer.model.load_state_dict(init, strict=True)
  from mmt_tpu.train import checkpoint as jax_ckpt
  raw = jax_ckpt.load_checkpoint_raw(exps / "jax" / "trained_model.msgpack")
  trained = convert.state_dict_from_flax(raw["params"], raw["batch_stats"])
  port_trainer.model.load_state_dict(trained, strict=True)


def test_parity_epoch_losses(parity):
  jax_trainer, port_trainer, exps, _ = parity
  want, got = _epoch_losses(exps / "jax"), _epoch_losses(exps / "port")
  assert len(got) == len(want) == 3
  np.testing.assert_allclose(got, want, rtol=LOSS_RTOL)
  assert (port_trainer.n_steps, port_trainer.n_samples) == (
      jax_trainer.n_steps, jax_trainer.n_samples)


def test_parity_final_sims(parity):
  _, _, exps, _ = parity
  want, got = _sims(exps / "jax"), _sims(exps / "port")
  np.testing.assert_array_equal(got["query_masks"], want["query_masks"])
  np.testing.assert_allclose(got["sims"], want["sims"], rtol=0,
                             atol=SIMS_TOL)


def test_parity_metrics(parity):
  """Ranks equal for every query whose sims are all further apart than
  SIMS_TOL; the reported metrics equal when that holds for every query
  (MeanR up to the fp32 mean the JAX package's device path takes)."""
  _, _, exps, _ = parity
  want, got = _sims(exps / "jax"), _sims(exps / "port")
  gaps = np.diff(np.sort(want["sims"], axis=1), axis=1).min(axis=1)
  clear = gaps > SIMS_TOL
  assert clear.any()
  ranks = [ranking.t2v_ranks(torch.from_numpy(s["sims"])).numpy()
           for s in (want, got)]
  np.testing.assert_array_equal(ranks[1][clear], ranks[0][clear])
  if clear.all():
    a, b = results(exps / "jax"), results(exps / "port")
    assert set(a) == set(b)
    for key in a:
      if "MeanR" in key:
        np.testing.assert_allclose(b[key], a[key], rtol=1e-6, err_msg=key)
      else:
        assert b[key] == a[key], key


def parity_gaps(exp_a, exp_b):
  """Largest relative gap of the trained epochs' mean losses, largest
  absolute gap of the final sims."""
  a, b = _epoch_losses(exp_a)[1:], _epoch_losses(exp_b)[1:]
  loss = float(np.max(np.abs(np.subtract(a, b)) / np.abs(b)))
  return loss, float(np.abs(_sims(exp_a)["sims"] - _sims(exp_b)["sims"]).max())


def test_parity_gap_at_the_configs_range_is_rounding_sized(workspace,
                                                          tmp_path_factory):
  """At the config's initializer_range (0.02) the run is ill-conditioned:
  the port from its initial weights moved by one rounding (each weight
  times 1 + u, |u| <= 2^-24; three draws) already differs from the
  unmoved port by more than the parity tolerances, and the JAX CLI
  differs from the port by no more than the largest of those gaps."""
  exps = tmp_path_factory.mktemp("parity_002")
  _, _, init = jax_and_port_runs(workspace, exps, CONFIG_INIT_RANGE)
  moved = []
  for draw in range(3):
    port_run(workspace, exps, f"moved{draw}",
             moved_by_one_rounding(init, draw), CONFIG_INIT_RANGE)
    moved.append(parity_gaps(exps / f"moved{draw}", exps / "port"))
  loss_moved, sims_moved = map(max, zip(*moved))
  loss_jax, sims_jax = parity_gaps(exps / "port", exps / "jax")
  assert loss_moved > LOSS_RTOL and sims_moved > SIMS_TOL, moved
  assert loss_jax <= loss_moved, (loss_jax, moved)
  assert sims_jax <= sims_moved, (sims_jax, moved)
