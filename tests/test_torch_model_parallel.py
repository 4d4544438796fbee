"""The port's data x tensor parallelism (``parallel.data_mesh``, the
trainer's ``model_parallel``) against its single process and the JAX
package.

Groups of gloo ranks started by ``parallel.spawn`` (one thread a rank)
run the rank-side checks of tests/torch_mp_ranks.py: two ranks for the
1 x 2 layout, four for the 2 x 2 one.  The JAX side runs on the 8-device
virtual CPU mesh.  fp32, the plain versions.  Tolerances:

- the layout: each rank's (data, model) place, and the ranks each group
  holds, equal to ``mmt_tpu/parallel/mesh.py:data_mesh(model_parallel=M)``'s
  device grid for M = 1, 2, 4; a world M does not divide raises; a model
  group across two hostnames raises;
- the step (every rate 0) at 1 x 2 and 2 x 2: the loss 1e-6 relative,
  the gradients 1e-4 against JAX's TP step on the 4 x 2 mesh and 1e-5
  against the port's single process; with dropout at 2 x 2 against the
  port's single process from the same generator: loss 1e-6, gradients
  1e-5, BatchNorm buffers 1e-6; the gradients summed over the data group
  only (a further sum over the model group doubles every replicated
  gradient and fails the comparison);
- every CENet switch: the phase-13 configs (bertfrz1 + mnp + ordr +
  vid_wgh emb under Ranger; coll + bertftnmxp + gem with missing
  modalities dropped; wo2vfrz + NetVLAD) and relu / swish at 1 x 2
  against the single process from the same dropout generator: the train
  forward, the loss and the gradients 1e-4, the BatchNorm buffers 1e-6,
  the optimizer's state gathered 1e-5;
- the CLI (``python -m mmt_tpu_torch.train``, 2 processes at
  ``model_parallel`` 2, text tower at initializer_range 0.5) against
  ``cli.main`` in one process over 2 epochs: the epoch losses 1e-5
  relative, the final-eval metrics equal, the checkpoints' keys and
  shapes equal; the TP run's ``trained_model.pth`` evaluated unsharded
  reproduces its final sims (rtol 1e-4, atol 1e-5); a one-process
  checkpoint resumed under TP (``MMT_TPU_MODEL_PARALLEL``), and a TP
  checkpoint resumed in one process, each give the one process's resumed
  epoch at 1e-5 relative (a restart's data stream starts again from the
  seed, in both packages, so the resumed epoch is not the uninterrupted
  run's);
- the requests that cannot be honored raise the JAX trainer's message.
"""

import json
import os
import pathlib
import shutil
import subprocess
import sys
import types

import jax
import numpy as np
import pytest
import torch

from mmt_tpu.models.cenet import CENet as FlaxCENet
from mmt_tpu.models.cenet import similarity_from_outputs as flax_sims
from mmt_tpu.parallel import mesh as jax_mesh
from mmt_tpu.train import losses as flax_losses
from mmt_tpu_torch import cli, convert, parallel
from mmt_tpu_torch.data import synthetic
from mmt_tpu_torch.models.cenet import CENet
from mmt_tpu_torch.parallel import mesh as mesh_lib
from mmt_tpu_torch.train import trainer as trainer_lib
from tests import torch_mp_ranks
from tests.conftest import make_batch

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent))
from test_train_e2e import make_config  # noqa: E402

REPO = pathlib.Path(__file__).resolve().parent.parent
MP = 2
TIMEOUT = 300.0
NO_DROPOUT = {"hidden_dropout_prob": 0.0, "attention_probs_dropout_prob": 0.0}
RANGER = {"type": "Ranger", "args": {"lr": 5e-5, "weight_decay": 0,
                                     "k": 6}}
DS = "MSRVTT_jsfusion_test"


def _no_dropout(arch):
  arch = dict(arch)
  arch["vid_bert_params"] = {**arch["vid_bert_params"], **NO_DROPOUT}
  arch["txt_bert_params"] = dict(NO_DROPOUT)
  return arch


def _act(arch, act):
  return dict(arch, vid_bert_params={**arch["vid_bert_params"],
                                     "hidden_act": act},
              text_bert_geometry={**arch["text_bert_geometry"],
                                  "hidden_act": act})


def _port_init(arch, seed=0):
  model = CENet(**arch, device="cpu")
  model.init_weights(torch.Generator().manual_seed(seed))
  return {k: v.numpy() for k, v in model.state_dict().items()}


@pytest.fixture(scope="module")
def setup(tiny_arch):
  """The flax init of the tiny CENet (rates 0) and its port state dict,
  the global batch of 4, the step cases and the switch cases."""
  batch = make_batch(tiny_arch["expert_dims"], b=4, k=2, t=7, l=5, seed=3)
  nodrop = _no_dropout(tiny_arch)
  model = FlaxCENet(**nodrop)
  variables = jax.tree_util.tree_map(np.asarray, model.init(
      {"params": jax.random.PRNGKey(0), "dropout": jax.random.PRNGKey(1)},
      batch, train=False))
  sd = {k: v.numpy() for k, v in convert.state_dict_from_flax(
      variables["params"], variables["batch_stats"]).items()}
  switch_arches = {
      "a_bertfrz_mnp_emb_ranger": (
          dict(tiny_arch, txt_agg="bertfrz1mnp", pos_enc="ordr",
               out_tok="mnp", vid_wgh="emb"), ("bertfrz1mnp", "bertftn"),
          RANGER),
      "b_coll_mxp_gem": (
          dict(tiny_arch, vid_cont="coll", vid_inp="agg", vid_wgh="nrm",
               txt_agg="bertftnmxp", txt_pro="gem",
               keep_missing_modalities=False), None, torch_mp_ranks.SPEC),
      "c_wo2vfrz_vlad": (
          dict(tiny_arch, txt_agg="vlad", we_vocab_size=100, we_dim=32),
          ("vlad", "wo2vfrz"), torch_mp_ranks.SPEC),
      "relu": (_act(tiny_arch, "relu"), None, torch_mp_ranks.SPEC),
      "swish": (_act(tiny_arch, "swish"), None, torch_mp_ranks.SPEC)}
  switches = {name: (arch, _port_init(arch), batch, 5, freeze, spec)
              for name, (arch, freeze, spec) in switch_arches.items()}
  steps = {"no_dropout": (nodrop, sd, batch, 0),
           "dropout": (tiny_arch, sd, batch, 5)}
  return dict(flax=(model, variables), batch=batch, steps=steps,
              switches=switches)


@pytest.fixture(scope="module")
def one_by_two(setup):
  return parallel.spawn(torch_mp_ranks.one_by_two, 2,
                        setup["steps"]["no_dropout"], setup["switches"],
                        timeout=TIMEOUT)


@pytest.fixture(scope="module")
def two_by_two(setup):
  return parallel.spawn(torch_mp_ranks.two_by_two, 4, setup["steps"],
                        timeout=TIMEOUT)


@pytest.fixture(scope="module")
def single(setup):
  """The port's single-process steps of every case on the whole batch."""
  out = {name: torch_mp_ranks.step(*case)
         for name, case in setup["steps"].items()}
  for name, (arch, sd, batch, seed, freeze, spec) in setup["switches"].items():
    out[name] = torch_mp_ranks.step(arch, sd, batch, seed, freeze=freeze,
                                    spec=spec)
  return out


@pytest.fixture(scope="module")
def jax_tp(setup):
  """JAX's TP step on the 4 x 2 mesh, every rate 0: (loss, gradients by
  the port's names)."""
  model, variables = setup["flax"]
  mesh = jax_mesh.data_mesh(model_parallel=MP)
  params = jax_mesh.shard_params(mesh, variables["params"])
  stats = variables["batch_stats"]
  loss_fn = flax_losses.max_margin_ranking_loss(0.05, True)

  def loss(p):
    out, _ = model.apply({"params": p, "batch_stats": stats},
                         setup["batch"], train=True,
                         rngs={"dropout": jax.random.PRNGKey(2)},
                         mutable=["batch_stats"])
    return loss_fn(flax_sims(out, merge="avg"))

  value, grads = jax.jit(jax.value_and_grad(loss))(params)
  sd = convert.state_dict_from_flax(
      jax.tree_util.tree_map(np.asarray, grads), stats)
  return float(value), {k: v.numpy() for k, v in sd.items()
                        if not k.endswith(("num_batches_tracked",
                                           "running_mean", "running_var"))}


def assert_close(got, want, tol, what):
  assert set(got) == set(want), what
  for name, w in want.items():
    if w is None:
      assert got[name] is None, f"{what}: {name}"
      continue
    np.testing.assert_allclose(got[name], w, rtol=tol, atol=tol,
                               err_msg=f"{what}: {name}")


# ----------------------------------------------------------------------
# The layout
# ----------------------------------------------------------------------
@pytest.mark.parametrize("mp", [1, 2, 4])
def test_layout_matches_jax_data_mesh(two_by_two, mp):
  """Rank r is model rank r % M of data rank r // M: JAX's device grid
  ``reshape(n // M, M)`` over the same 4 devices; each group holds the
  ranks of its column (data) or row (model)."""
  grid = np.vectorize(lambda d: d.id)(
      jax_mesh.data_mesh(jax.devices()[:4], model_parallel=mp).devices)
  for rank, r in enumerate(two_by_two):
    (row,), (col,) = np.nonzero(grid == rank)
    rows, cols = grid.shape
    place = [row if rows > 1 else 0, rows, col if cols > 1 else 0, cols]
    assert r["layout"][mp]["place"] == place
    sums = [float(grid[:, col].sum()) if rows > 1 else rank,
            float(grid[row].sum()) if cols > 1 else rank]
    assert r["layout"][mp]["sums"] == sums


def test_a_world_the_model_axis_does_not_divide_raises(two_by_two):
  for r in two_by_two:
    assert "model_parallel=3 does not divide the 4 ranks" in r["layout"][
        "mp3"]
  with pytest.raises(ValueError, match="does not divide the 3 ranks"):
    mesh_lib.data_mesh(mesh_lib.Group(0, 3), 2)


def test_a_model_group_across_hosts_raises(two_by_two):
  for r in two_by_two:
    assert r["hosts"]["by_pairs"] == (2, 2)
    assert "spans hosts ['host0', 'host1']" in r["hosts"]["by_parity"]
    assert "[0, 1]" in r["hosts"]["by_parity"]


# ----------------------------------------------------------------------
# The step
# ----------------------------------------------------------------------
@pytest.mark.parametrize("ref", ["port", "jax"])
@pytest.mark.parametrize("grid", ["1x2", "2x2"])
def test_tp_step_matches(one_by_two, two_by_two, single, jax_tp, grid, ref):
  """Every rate 0: the TP x DP step's loss and (gathered, data-summed)
  gradients against the single process and JAX's TP step."""
  ranks = ([r["step"] for r in one_by_two] if grid == "1x2"
           else [r["no_dropout"] for r in two_by_two])
  if ref == "jax":
    loss, grads, tol = *jax_tp, 1e-4
  else:
    loss, grads, tol = (single["no_dropout"]["loss"],
                        single["no_dropout"]["grads"], 1e-5)
  for r in ranks:
    assert abs(r["loss"] - loss) <= 1e-6 * abs(loss), (r["loss"], loss)
    assert_close(r["grads"], grads, tol, f"{grid} vs {ref}")


def test_dropout_step_2x2_matches_single_process(two_by_two, single):
  """Dropout on: every rank draws each mask at the global batch and all
  heads and keeps its rows and heads (the two-dim ``part``), so the 2 x 2
  step is the single-process step from the same generator."""
  want = single["dropout"]
  for r in two_by_two:
    got = r["dropout"]
    assert abs(got["loss"] - want["loss"]) <= 1e-6 * abs(want["loss"])
    assert_close(got["grads"], want["grads"], 1e-5, "dropout 2x2")
    assert got["buffers"]
    assert_close(got["buffers"], want["buffers"], 1e-6, "buffers")
    rows = slice(r["rows"][0] * 2, r["rows"][0] * 2 + 2)
    assert_close(got["outputs"], {k: v[rows] for k, v in
                                  want["outputs"].items()}, 1e-5, "outputs")


def test_gradients_summed_over_the_data_group_only(two_by_two, single):
  """A further sum over the model group doubles every replicated
  parameter's gradient, and the comparison of the step test fails."""
  want = single["no_dropout"]["grads"]
  for r in two_by_two:
    right, wrong = r["no_dropout"]["grads"], r["no_dropout"]["wrong_grads"]
    replicated = [n for n in right if n not in r["no_dropout"]["shard_dims"]]
    assert replicated
    for name in replicated:
      np.testing.assert_allclose(wrong[name], 2 * right[name], rtol=1e-6,
                                 atol=1e-12, err_msg=name)
    with pytest.raises(AssertionError):
      assert_close(wrong, want, 1e-5, "summed over both groups")


# ----------------------------------------------------------------------
# Every switch
# ----------------------------------------------------------------------
@pytest.mark.parametrize("case", ["a_bertfrz_mnp_emb_ranger",
                                  "b_coll_mxp_gem", "c_wo2vfrz_vlad",
                                  "relu", "swish"])
def test_switch_under_tp_matches_single_process(one_by_two, single, case):
  """The TP train forward, loss and gradients (frozen parameters
  without one, by name on the shards), the BatchNorm buffers and the
  optimizer's gathered state, against the single process."""
  want = single[case]
  dims = one_by_two[0][case]["shard_dims"]
  towers = {n.split(".")[0] for n in dims}
  assert towers == {"a_bertfrz_mnp_emb_ranger": {"txt_bert", "vid_bert"},
                    "b_coll_mxp_gem": {"txt_bert"},
                    "c_wo2vfrz_vlad": {"vid_bert"}}.get(
                        case, {"txt_bert", "vid_bert"})
  for r in one_by_two:
    got = r[case]
    assert abs(got["loss"] - want["loss"]) <= 1e-4 * abs(want["loss"])
    assert_close(got["outputs"], want["outputs"], 1e-4, "outputs")
    assert_close(got["grads"], want["grads"], 1e-4, "grads")
    assert_close(got["buffers"], want["buffers"], 1e-6, "buffers")
    assert got["reshard_equal"]
    assert set(got["optimizer"]) == set(want["optimizer"])
    for i, entry in want["optimizer"].items():
      assert_close(got["optimizer"][i], entry, 1e-5, f"optimizer {i}")
  frozen = [n for n, g in want["grads"].items() if g is None]
  assert bool(frozen) == (case[0] in "ac")
  if case.startswith("a"):
    assert "slow_buffer" in want["optimizer"][0]


def test_a_model_without_a_bert_tower_replicates_everything(tiny_arch,
                                                            caplog):
  arch = dict(tiny_arch, vid_cont="coll", vid_inp="agg", vid_wgh="nrm",
              txt_agg="vlad", we_vocab_size=100, we_dim=32)
  with caplog.at_level("INFO", logger="mmt_tpu_torch.models.cenet"):
    model = CENet(**arch, device="cpu", tp=mesh_lib.Group(0, 2))
  assert model.shard_dims == {}
  assert any("every parameter is replicated on the 2 ranks" in
             r.getMessage() for r in caplog.records)


# ----------------------------------------------------------------------
# The CLI
# ----------------------------------------------------------------------
def _cli_config(root, data_dir, exp, mp=1):
  cfg = make_config(root, data_dir, exp)
  cfg.pop("visualizer")
  cfg["arch"]["args"]["text_bert_geometry"]["initializer_range"] = 0.5
  cfg["trainer"]["num_keep_ckpts"] = 2
  if mp > 1:
    cfg["trainer"]["model_parallel"] = mp
  return cfg


def _tp_cli(argv, env):
  """Start ``python -m mmt_tpu_torch.train argv`` on MP processes."""
  port = mesh_lib._free_port()
  return [subprocess.Popen(
      [sys.executable, "-m", "mmt_tpu_torch.train", *argv, "--device",
       "cpu"], cwd=REPO, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
      text=True, env=dict(os.environ, **env, OMP_NUM_THREADS="2",
                          MMT_TPU_COORDINATOR=f"localhost:{port}",
                          MMT_TPU_NUM_PROCESSES=str(MP),
                          MMT_TPU_PROCESS_ID=str(rank),
                          PYTHONPATH=str(REPO)))
      for rank in range(MP)]


def _wait(procs):
  try:
    outs = [p.communicate(timeout=TIMEOUT)[0] for p in procs]
  finally:
    for p in procs:
      if p.poll() is None:
        p.kill()
        p.wait()
  for p, out in zip(procs, outs):
    assert p.returncode == 0, out[-4000:]
  return outs


def _resume_dir(src, dst, mp=None):
  """A new experiment dir holding ``src``'s epoch-1 checkpoint and its
  config (save_dir pointed at the new dir; ``model_parallel`` dropped or
  set to ``mp``): resumed from there, the run trains epoch 2."""
  dst.mkdir()
  shutil.copy(src / "checkpoint-epoch1.pth", dst)
  cfg = json.loads((src / "config.json").read_text())
  cfg["trainer"]["save_dir"] = str(dst)
  cfg["trainer"].pop("model_parallel", None)
  if mp:
    cfg["trainer"]["model_parallel"] = mp
  (dst / "config.json").write_text(json.dumps(cfg))
  return ["--resume", str(dst / "checkpoint-epoch1.pth")]


@pytest.fixture(scope="module")
def cli_runs(tmp_path_factory):
  """(a) one process and (b) two TP processes, 2 epochs from the same
  config; (c) (b)'s trained_model.pth evaluated in one process; (d) (a)'s
  epoch-1 checkpoint resumed by two processes with MMT_TPU_MODEL_PARALLEL
  2, (e) (b)'s resumed in one process and (f) (a)'s resumed in one
  process, each to epoch 2.  The subprocesses run while this process
  runs the others."""
  root = tmp_path_factory.mktemp("torch_mp_cli")
  data_dir = synthetic.generate(root, num_videos=14, num_test=6,
                                experts={"rgb": 2048, "s3d": 1024},
                                captions_per_video=3)
  vocab = str(root / "vocab.txt")
  exps = {n: root / f"exp_{n}" for n in "abcdef"}
  for name, mp in (("a", 1), ("b", MP)):
    (root / f"{name}.json").write_text(json.dumps(
        _cli_config(root, data_dir, exps[name], mp)))
  (root / "c.json").write_text(json.dumps(
      _cli_config(root, data_dir, exps["c"])))
  prev = os.environ.get("MMT_TPU_BERT_VOCAB")
  os.environ["MMT_TPU_BERT_VOCAB"] = vocab
  try:
    procs = _tp_cli(["--config", str(root / "b.json")],
                    {"MMT_TPU_BERT_VOCAB": vocab})
    cli.main(["--config", str(root / "a.json"), "--device", "cpu"])
    outs = {"b": _wait(procs)}
    procs = _tp_cli(_resume_dir(exps["a"], exps["d"]),
                    {"MMT_TPU_BERT_VOCAB": vocab,
                     "MMT_TPU_MODEL_PARALLEL": str(MP)})
    cli.main(["--config", str(root / "c.json"), "--only_eval",
              "--load_checkpoint", str(exps["b"] / "trained_model.pth"),
              "--device", "cpu"])
    for name, src in (("e", "b"), ("f", "a")):
      cli.main(_resume_dir(exps[src], exps[name]) + ["--device", "cpu"])
    outs["d"] = _wait(procs)
  finally:
    if prev is None:
      os.environ.pop("MMT_TPU_BERT_VOCAB", None)
    else:
      os.environ["MMT_TPU_BERT_VOCAB"] = prev
  return exps, outs


def _losses(exp):
  with open(exp / "perf_log.txt") as f:
    return [json.loads(line)["loss"] for line in f]


def _sims(exp):
  return np.load(exp / "MSRVTT-test-sims.npy", allow_pickle=True)[()]["sims"]


def _perfs(exp):
  return json.loads((exp / "exp_results.json").read_text())["perfs"][DS]


def test_cli_tp_matches_one_process(cli_runs):
  exps, outs = cli_runs
  assert "tensor parallel: model rank 1 of 2" in outs["b"][1]
  assert "log.p1.txt" in os.listdir(exps["b"])
  two, one = _losses(exps["b"]), _losses(exps["a"])
  assert len(two) == len(one) == 3
  np.testing.assert_allclose(two, one, rtol=1e-5)
  assert _perfs(exps["b"]) == _perfs(exps["a"])


def test_cli_tp_checkpoint_has_the_one_process_format(cli_runs):
  """Parameters and Adam's moments gathered: the same keys and shapes."""
  exps, _ = cli_runs
  tp, one = (torch.load(exps[n] / "checkpoint-epoch1.pth",
                        weights_only=True) for n in "ba")
  for key in ("state_dict",):
    assert {k: tuple(v.shape) for k, v in tp[key].items()} == {
        k: tuple(v.shape) for k, v in one[key].items()}
  got, want = tp["optimizer"]["state"], one["optimizer"]["state"]
  assert set(got) == set(want) and want
  for i in want:
    assert {k: tuple(v.shape) for k, v in got[i].items()} == {
        k: tuple(v.shape) for k, v in want[i].items()}


def test_cli_tp_checkpoint_evaluates_unsharded(cli_runs):
  """--only_eval --load_checkpoint of the TP run's trained_model.pth in
  one process reproduces the TP run's final sims (test_parallel.py:945)."""
  exps, _ = cli_runs
  np.testing.assert_allclose(_sims(exps["c"]), _sims(exps["b"]), rtol=1e-4,
                             atol=1e-5)


@pytest.mark.parametrize("resumed", ["d", "e"])
def test_cli_resume_across_layouts(cli_runs, resumed):
  """(d) the one process's checkpoint resumed under TP (read from
  MMT_TPU_MODEL_PARALLEL), (e) the TP checkpoint resumed in one process:
  epoch 2 as the one process resumes it (f); Adam's moments carried."""
  exps, outs = cli_runs
  if resumed == "d":
    assert "tensor parallel: model rank 0 of 2" in outs["d"][0]
  got, want = _losses(exps[resumed]), _losses(exps["f"])
  assert len(got) == len(want) == 1
  np.testing.assert_allclose(got, want, rtol=1e-5)


# ----------------------------------------------------------------------
# Requests that cannot be honored
# ----------------------------------------------------------------------
def _bad_config(tmp_path, **trainer):
  cfg = make_config(tmp_path, tmp_path / "no_data", tmp_path / "exp")
  cfg["trainer"].update(trainer)
  path = tmp_path / "bad.json"
  path.write_text(json.dumps(cfg))
  return ["--config", str(path), "--device", "cpu"]


def test_one_process_cannot_honor_model_parallel(tmp_path, monkeypatch):
  monkeypatch.delenv("MMT_TPU_COORDINATOR", raising=False)
  monkeypatch.delenv("MMT_TPU_MODEL_PARALLEL", raising=False)
  with pytest.raises(ValueError, match="model_parallel=2 was requested"):
    cli.main(_bad_config(tmp_path, model_parallel=2))


def test_model_parallel_read_from_the_environment(tmp_path, monkeypatch):
  monkeypatch.delenv("MMT_TPU_COORDINATOR", raising=False)
  monkeypatch.setenv("MMT_TPU_MODEL_PARALLEL", "2")
  assert trainer_lib.model_parallel({}) == 2
  assert trainer_lib.model_parallel({"model_parallel": 1}) == 1
  with pytest.raises(ValueError, match="model_parallel=2 was requested"):
    cli.main(_bad_config(tmp_path))


def test_batch_the_data_axis_does_not_divide_raises():
  """Batch 3 on 2 data ranks: no replicated fallback under TP."""
  class Entry(dict):   # an ExpertDataLoader's surface
    pass

  entry = Entry(loader=types.SimpleNamespace(num_workers=0))
  entry.batch_size = 3
  stub = types.SimpleNamespace(
      data_loaders={"train_sets": [entry]}, model_parallel=2,
      tp=mesh_lib.Group(0, 2))
  with pytest.raises(ValueError, match="model_parallel=2 was requested"):
    trainer_lib.Trainer._tensor_parallel_rows(stub, mesh_lib.Group(0, 2))
  entry.batch_size = 4
  group = mesh_lib.Group(1, 2)
  assert trainer_lib.Trainer._tensor_parallel_rows(stub, group) is group


def test_world_the_model_axis_does_not_divide_cannot_be_honored():
  with pytest.raises(ValueError, match="model_parallel=2 was requested"):
    trainer_lib.parallel_layout(mesh_lib.Group(0, 3), 2)
  assert trainer_lib.parallel_layout(None, 1) == (None, None)
