"""The port's data parallelism against its single process and the JAX
package.

Two gloo ranks started by ``parallel.spawn`` run every rank-side check of
tests/torch_dp_ranks.py once (fp32, the plain versions, one thread a
rank); a second group of three ranks runs the sharded fused metrics.
Tolerances:

- the DP step at 2 ranks (global batch 8, dropout 0.1 from generator
  seed 5) against the port's single-process step on the whole batch: the
  loss 1e-6 relative, the gradients (summed over the ranks) 1e-5, the
  BatchNorm running buffers 1e-6; also on the collaborative-gating
  switch, whose ContextGatingReasoning BatchNorms take the other
  moment site; after 3 Adam steps every parameter and buffer bitwise
  equal on both ranks;
- the same step with every dropout rate 0 against the JAX package's
  single-device step from the same converted weights: the loss 1e-6
  relative, the gradients 1e-4 (fp32 sum-order noise through two 2-layer
  towers, as in test_torch_train_step.py);
- the sharded fused metrics (21 videos x 2 captions, some masked, numpy
  seed 1, as tests/test_parallel.py:871) over 2 ranks (one pad video)
  and over 3: every metric equal to the unsharded call's, the port's and
  the JAX package's (rtol 1e-6);
- the CLI over two processes through the environment interface against
  one process: the epoch losses 1e-5 relative, the final-eval metrics
  equal, a trained parameter's fingerprint 1e-5; one set of artifacts;
- host-staged embeddings bitwise equal to the device path's.
"""

import json
import os
import pathlib
import subprocess
import sys
import types

import jax
import numpy as np
import pytest
import torch

from mmt_tpu.models.cenet import CENet as FlaxCENet
from mmt_tpu.models.cenet import similarity_from_outputs as flax_sims
from mmt_tpu.train import losses as flax_losses
from mmt_tpu.train import metrics as jax_metrics
from mmt_tpu_torch import cli, convert, parallel
from mmt_tpu_torch.data import synthetic
from mmt_tpu_torch.models.cenet import CENet
from mmt_tpu_torch.parallel import mesh as mesh_lib
from mmt_tpu_torch.train import metrics
from mmt_tpu_torch.train import trainer as trainer_lib
from tests import torch_dp_ranks
from tests.conftest import make_batch

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent))
from test_train_e2e import make_config  # noqa: E402

REPO = pathlib.Path(__file__).resolve().parent.parent
DP = 2
TIMEOUT = 240.0
NO_DROPOUT = {"hidden_dropout_prob": 0.0, "attention_probs_dropout_prob": 0.0}
COLL = {"vid_cont": "coll", "vid_inp": "agg", "vid_wgh": "nrm"}
DS = "MSRVTT_jsfusion_test"


def _no_dropout(arch):
  arch = dict(arch)
  arch["vid_bert_params"] = {**arch["vid_bert_params"], **NO_DROPOUT}
  arch["txt_bert_params"] = dict(NO_DROPOUT)
  return arch


def _torch_names(tree, stats):
  """Flax tree -> {port name: numpy}, BN buffers left out."""
  sd = convert.state_dict_from_flax(jax.tree_util.tree_map(np.asarray, tree),
                                    stats)
  return {k: v.numpy() for k, v in sd.items()
          if not k.endswith(("num_batches_tracked", "running_mean",
                             "running_var"))}


@pytest.fixture(scope="module")
def setup(tiny_arch):
  """The flax init of the tiny CENet (and its converted state dict), the
  global batch of 8, the port's own init of the coll switch, and the
  cases every rank runs."""
  batch = make_batch(tiny_arch["expert_dims"], b=8, k=2, t=7, l=5, seed=3)
  nodrop = _no_dropout(tiny_arch)
  model = FlaxCENet(**nodrop)
  variables = jax.tree_util.tree_map(np.asarray, model.init(
      {"params": jax.random.PRNGKey(0), "dropout": jax.random.PRNGKey(1)},
      batch, train=False))
  sd = {k: v.numpy() for k, v in convert.state_dict_from_flax(
      variables["params"], variables["batch_stats"]).items()}
  coll = dict(tiny_arch, **COLL)
  coll_sd = {k: v.numpy() for k, v in CENet(**coll, device="cpu")
             .init_weights(torch.Generator().manual_seed(0))
             .state_dict().items()}
  cases = {"dropout": (tiny_arch, sd, batch, 5),
           "no_dropout": (nodrop, sd, batch, 0),
           "coll": (coll, coll_sd, batch, 5)}
  return dict(cases=cases, flax=(model, variables), batch=batch)


def fused_inputs():
  """The corpus of tests/test_parallel.py:871."""
  rng = np.random.RandomState(1)
  v, cpv, m, d = 21, 2, 3, 16
  q = v * cpv
  te = rng.randn(q, m, d).astype(np.float32)
  ve = rng.randn(v, m, d).astype(np.float32)
  tw = np.abs(rng.randn(q, m)).astype(np.float32)
  vw = np.abs(rng.randn(v, m)).astype(np.float32)
  masks = (rng.rand(v, cpv) > 0.2).astype(np.float32)
  masks[:, 0] = 1.0
  return te, ve, tw, vw, masks


@pytest.fixture(scope="module")
def ranks(setup):
  return parallel.spawn(torch_dp_ranks.all_checks, DP, setup["cases"],
                        fused_inputs(), timeout=TIMEOUT)


@pytest.fixture(scope="module")
def single(setup):
  """The port's single-process steps of every case on the whole batch."""
  return {name: torch_dp_ranks.steps(*case)
          for name, case in setup["cases"].items()}


def test_gather_and_all_reduce_sum(ranks):
  """gather_rows: every rank's rows in rank order, the backward this
  rank's rows of the gradient; all_reduce_sum: the sum, the backward the
  sum of the ranks' gradients."""
  for rank, r in enumerate(ranks):
    c = r["collectives"]
    np.testing.assert_array_equal(
        c["gathered"], np.repeat([[1.0], [1.0], [2.0], [2.0]], 3, 1))
    np.testing.assert_array_equal(
        c["gather_grad"], np.repeat([[2.0 * rank + 1], [2.0 * rank + 2]],
                                    3, 1))
    np.testing.assert_array_equal(c["reduced"], np.full((2, 3), 3.0))
    np.testing.assert_array_equal(c["reduce_grad"], np.full((2, 3), 3.0))


@pytest.mark.parametrize("case", ["dropout", "coll"])
def test_dp_step_matches_single_process(ranks, single, case):
  """The DP step is the single-process step on the global batch: the
  dropout masks drawn at the global shape, the BatchNorm moments and
  running buffers global, the gradients summed over the ranks."""
  want = single[case]
  for r in ranks:
    got = r[case]
    assert abs(got["loss"] - want["loss"]) <= 1e-6 * abs(want["loss"])
    assert set(got["grads"]) == set(want["grads"])
    for name, w in want["grads"].items():
      np.testing.assert_allclose(got["grads"][name], w, rtol=1e-5,
                                 atol=1e-5, err_msg=name)
    assert got["buffers"] and set(got["buffers"]) == set(want["buffers"])
    for name, w in want["buffers"].items():
      np.testing.assert_allclose(got["buffers"][name], w, rtol=1e-6,
                                 atol=1e-6, err_msg=name)


@pytest.mark.parametrize("case", ["dropout", "no_dropout", "coll"])
def test_replicas_bitwise_equal_after_three_steps(ranks, case):
  a, b = (r[case]["state"] for r in ranks)
  assert set(a) == set(b) and a
  for name in a:
    np.testing.assert_array_equal(a[name], b[name], err_msg=name)


def test_dp_step_matches_jax_single_device(ranks, setup):
  """Every dropout rate 0: the JAX package's single-device step from the
  same weights on the global batch."""
  model, variables = setup["flax"]
  stats = variables["batch_stats"]
  loss_fn = flax_losses.max_margin_ranking_loss(0.05, True)

  def loss(p):
    out, _ = model.apply({"params": p, "batch_stats": stats},
                         setup["batch"], train=True,
                         rngs={"dropout": jax.random.PRNGKey(2)},
                         mutable=["batch_stats"])
    return loss_fn(flax_sims(out, merge="avg"))

  value, grads = jax.jit(jax.value_and_grad(loss))(variables["params"])
  want = _torch_names(grads, stats)
  for r in ranks:
    got = r["no_dropout"]
    assert abs(got["loss"] - float(value)) <= 1e-6 * abs(float(value))
    for name, w in want.items():
      np.testing.assert_allclose(got["grads"][name], w, rtol=1e-4,
                                 atol=1e-4, err_msg=name)


@pytest.fixture(scope="module")
def three_ranks():
  return parallel.spawn(torch_dp_ranks.fused_only, 3, fused_inputs(),
                        timeout=TIMEOUT)


@pytest.mark.parametrize("size", [2, 3])
@pytest.mark.parametrize("ref", ["port", "jax"])
def test_sharded_fused_metrics_equal_unsharded(ranks, three_ranks, size,
                                               ref):
  inputs = fused_inputs()
  want = (metrics.fused_retrieval_metrics(*inputs, device="cpu")
          if ref == "port" else jax_metrics.fused_retrieval_metrics(*inputs))
  results = ([r["fused"] for r in ranks] if size == 2 else three_ranks)
  assert len(results) == size
  for got in results:
    for which in ("t2v_metrics", "v2t_metrics"):
      assert set(got[which]) == set(want[which])
      for key in want[which]:
        np.testing.assert_allclose(got[which][key], want[which][key],
                                   rtol=1e-6, err_msg=f"{which}/{key}")


@pytest.mark.parametrize("world,device,cards,want", [
    (2, "cpu", 0, "gloo"), (2, "cpu", 4, "gloo"), (2, "cuda", 2, "nccl"),
    (2, "cuda", 8, "nccl"), (4, "cuda", 4, "nccl"), (2, "cuda", 1, "gloo"),
    (4, "cuda", 2, "gloo")])
def test_backend_rule(world, device, cards, want):
  """gloo on the CPU; NCCL when every rank has a card of its own; gloo
  when ranks share a card."""
  assert mesh_lib.choose_backend(world, device, cards) == want


def test_backend_rule_honours_cpu_collectives(monkeypatch):
  assert mesh_lib.choose_backend(2, "cpu", 0, "mpi") == "mpi"
  assert mesh_lib.choose_backend(2, "cuda", 2, "mpi") == "nccl"
  monkeypatch.delenv("MMT_TPU_COORDINATOR", raising=False)
  assert mesh_lib.maybe_initialize_distributed("cpu") is None
  monkeypatch.setenv("MMT_TPU_COORDINATOR", "localhost:1")
  monkeypatch.setenv("MMT_TPU_NUM_PROCESSES", "1")
  assert mesh_lib.maybe_initialize_distributed("cpu") is None
  monkeypatch.setenv("MMT_TPU_NUM_PROCESSES", "2")
  monkeypatch.setenv("MMT_TPU_PROCESS_ID", "2")
  with pytest.raises(ValueError, match="not a rank"):
    mesh_lib.maybe_initialize_distributed("cpu")


@pytest.mark.parametrize("batch_size,split", [(5, False), (4, True)])
def test_batch_that_does_not_divide_trains_replicated(caplog, batch_size,
                                                      split):
  """A train batch size the group does not divide: the whole run trains
  and evaluates replicated, and the log says so."""
  group = mesh_lib.DataParallel(0, 2)

  class Entry(dict):   # an ExpertDataLoader's surface
    pass

  entry = Entry(loader=types.SimpleNamespace(num_workers=0))
  entry.batch_size = batch_size
  stub = types.SimpleNamespace(group=group,
                               data_loaders={"train_sets": [entry]})
  with caplog.at_level("WARNING", logger=trainer_lib.logger.name):
    got = trainer_lib.Trainer._data_parallel(stub)
  assert (got is group) == split
  assert any("REPLICATED" in r.getMessage() for r in caplog.records) != split


@pytest.mark.parametrize("batch_size", [4, 5])
def test_loader_with_workers_raises_under_a_group(batch_size):
  """Worker threads draw the numpy stream in no fixed order, so the ranks'
  batches would differ: split or replicated, the trainer refuses them."""
  class Entry(dict):   # an ExpertDataLoader's surface
    pass

  entry = Entry(loader=types.SimpleNamespace(num_workers=2))
  entry.batch_size = batch_size
  stub = types.SimpleNamespace(group=mesh_lib.DataParallel(0, 2),
                               data_loaders={"train_sets": [entry]})
  with pytest.raises(ValueError, match="num_workers > 0"):
    trainer_lib.Trainer._data_parallel(stub)


def test_one_group_type_serves_both_axes():
  assert mesh_lib.DataParallel is mesh_lib.TensorParallel is mesh_lib.Group
  group = mesh_lib.Group(1, 2)
  assert not group.primary and group.rows(8) == slice(4, 8)


def test_local_rows_and_eval_padding():
  group = [mesh_lib.DataParallel(r, 2) for r in range(2)]
  batch = {"token_ids": np.arange(10).reshape(5, 2),
           "features": {"rgb": np.arange(5.0)}, "paths": list("abcde")}
  padded, n = mesh_lib.pad_batch_to_multiple(batch, 2)
  assert n == 5 and padded["token_ids"].shape == (6, 2)
  assert not padded["token_ids"][5].any() and padded["features"]["rgb"][5] == 0
  halves = [mesh_lib.local_rows(padded, g) for g in group]
  np.testing.assert_array_equal(
      np.concatenate([h["token_ids"] for h in halves]), padded["token_ids"])
  assert halves[1]["paths"] == ["d", "e", "e"]
  with pytest.raises(ValueError, match="does not divide"):
    mesh_lib.local_rows(batch, group[0])


# ----------------------------------------------------------------------
# The CLI over two processes
# ----------------------------------------------------------------------
def _cli_config(root, data_dir, exp, workers):
  cfg = make_config(root, data_dir, exp)
  # The continuous eval takes the fused path (host-staged, candidates
  # split over the ranks): no visualizer, which reads the sims matrix.
  cfg.pop("visualizer")
  cfg["trainer"]["fused_eval_from_videos"] = 1
  for key in ("continuous_eval_sets", "final_eval_sets"):
    cfg[key][0]["args"]["batch_size"] = 5   # 6 videos: batches pad
  for key in ("train_sets", "continuous_eval_sets", "final_eval_sets"):
    cfg[key][0]["args"]["num_workers"] = workers
  return cfg


@pytest.fixture(scope="module")
def cli_runs(tmp_path_factory):
  """The same config trained by 2 processes (python -m
  mmt_tpu_torch.train, the environment interface) and by 1 (cli.main)."""
  root = tmp_path_factory.mktemp("torch_dp_cli")
  data_dir = synthetic.generate(root, num_videos=14, num_test=6,
                                experts={"rgb": 2048, "s3d": 1024},
                                captions_per_video=3)
  vocab = str(root / "vocab.txt")
  exps = {}
  # The two processes' config asks for loader workers, which a group
  # runs at 0: their batches must still be the one process's.
  for name, workers in (("two", 2), ("one", 0)):
    exps[name] = root / f"exp_{name}"
    (root / f"{name}.json").write_text(json.dumps(
        _cli_config(root, data_dir, exps[name], workers)))
  port = mesh_lib._free_port()
  procs = []
  for rank in range(DP):
    env = dict(os.environ, MMT_TPU_BERT_VOCAB=vocab, OMP_NUM_THREADS="2",
               MMT_TPU_COORDINATOR=f"localhost:{port}",
               MMT_TPU_NUM_PROCESSES=str(DP), MMT_TPU_PROCESS_ID=str(rank),
               PYTHONPATH=str(REPO))
    procs.append(subprocess.Popen(
        [sys.executable, "-m", "mmt_tpu_torch.train", "--config",
         str(root / "two.json"), "--device", "cpu"], cwd=REPO, env=env,
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
  try:
    outs = [p.communicate(timeout=TIMEOUT)[0] for p in procs]
  finally:
    for p in procs:
      if p.poll() is None:
        p.kill()
        p.wait()
  for p, out in zip(procs, outs):
    assert p.returncode == 0, out[-4000:]
  os.environ["MMT_TPU_BERT_VOCAB"] = vocab
  one = cli.main(["--config", str(root / "one.json"), "--device", "cpu"])
  return exps, outs, one


def _losses(exp):
  with open(exp / "perf_log.txt") as f:
    return [json.loads(line)["loss"] for line in f]


def _perfs(exp):
  return json.loads((exp / "exp_results.json").read_text())["perfs"][DS]


def test_cli_two_processes_match_one(cli_runs):
  exps, outs, _ = cli_runs
  assert "fused on-device ranking" in outs[0] and "split over 2" in outs[0]
  two, one = _losses(exps["two"]), _losses(exps["one"])
  assert len(two) == len(one) == 3
  np.testing.assert_allclose(two, one, rtol=1e-5)
  assert _perfs(exps["two"]) == _perfs(exps["one"])
  finger = []
  for exp in (exps["two"], exps["one"]):
    state = torch.load(exp / "trained_model.pth", weights_only=False)
    finger.append(float(state["state_dict"]["moe_fc_txt.rgb.weight"].abs()
                        .sum()))
  np.testing.assert_allclose(finger[0], finger[1], rtol=1e-5)


def test_cli_two_processes_write_one_set_of_artifacts(cli_runs):
  exps, outs, _ = cli_runs
  # TensorBoard names its files by the second and the host: compared by
  # count at the top level (one stream), not by name.
  listing = lambda exp: sorted(str(p.relative_to(exp))
                               for p in exp.rglob("*") if p.is_file()
                               and "tfevents" not in p.name)
  two, one = listing(exps["two"]), listing(exps["one"])
  assert "log.p1.txt" in two
  assert [f for f in two if f != "log.p1.txt"] == one
  assert (len(list(exps["two"].glob("*tfevents*")))
          == len(list(exps["one"].glob("*tfevents*"))) <= 1)
  assert "data parallel: rank 1 of 2 over gloo" in (
      exps["two"] / "log.p1.txt").read_text()


def test_cli_loaders_run_without_workers_in_a_group(cli_runs):
  _, outs, _ = cli_runs
  for out in outs:
    assert out.count("num_workers 2 -> 0") == 3, out[-4000:]


def test_host_staged_embeddings_equal_device_path(cli_runs):
  trainer = cli_runs[2]
  loader = trainer.data_loaders["final_eval_sets"][0]["loader"]
  dev = trainer._get_embeddings(loader)
  host = trainer._get_embeddings(loader, to_host=True)
  for key in ("vid_embds", "text_embds", "vid_weights", "text_weights"):
    assert isinstance(host[key], np.ndarray)
    want = dev[key].cpu().numpy()
    assert host[key].dtype == want.dtype and host[key].shape == want.shape
    assert host[key].tobytes() == want.tobytes(), key
  np.testing.assert_array_equal(host["query_masks"], dev["query_masks"])
  assert host["paths"] == dev["paths"]
