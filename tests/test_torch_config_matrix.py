"""The config matrix of tests/test_config_matrix_e2e.py through the port's
CLI (``mmt_tpu_torch.cli``, ``--device cpu``), and whole-run parity with
the JAX CLI for the collaborative-gating and the word-vector NetVLAD
configs.

Each case trains one epoch and evaluates, as its JAX counterpart does:
``infonce_ranger``, ``coll``, ``none_gem``, ``bad_emb`` (a config error),
``mxp_ordr``, ``frozen`` and ``wo2v_vlad``.  Parity: the same config
(every dropout rate 0, the text tower drawn at initializer_range 0.5, see
tests/test_torch_trainer.py:parity_config, and Adam's eps 1e-4, see
PARITY_EPS) trained 2 epochs by the JAX CLI's functions and by the port's
CLI from the JAX trainer's initial weights: each epoch's mean loss at
1e-4 relative, the final sims at 1e-4, ranks equal wherever no two sims
of a query lie within 1e-4; at the config's eps the gap is held to what
one rounding of the initial weights moves the port by.  Serving:
the JAX-trained models of those two runs served by the port
(``serve.load_model_and_loader`` on the JAX CLI's ``.msgpack``, the word
vectors from ``MMT_TPU_WORD_VECTORS``) against mmt_tpu/serving.py: index
and exact scores at 1e-5.
"""

import argparse
import json
import os
import pathlib
import sys

import numpy as np
import pytest
import torch

from mmt_tpu_torch import cli, convert, serve, serving
from mmt_tpu_torch.data import synthetic
from mmt_tpu_torch.models.cenet import CENet, cenet_kwargs_from_arch_args
from mmt_tpu_torch.ops import ranking

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent))
from test_train_e2e import make_config  # noqa: E402

DS = "MSRVTT_jsfusion_test"
LOSS_RTOL, SIMS_TOL, SERVE_TOL = 1e-4, 1e-4, 1e-5
QUERIES = ["a video of cooking", "a video of soccer", "a man cooks rain"]

# name -> (arch.args tweaks, top-level tweaks): the cases of
# tests/test_config_matrix_e2e.py.
MATRIX = {
    "infonce_ranger": ({}, {"loss": {"type": "InfoNceLoss", "args": {}},
                            "optimizer": {"type": "Ranger",
                                          "args": {"lr": 1e-3}}}),
    "coll": ({"vid_cont": "coll", "vid_inp": "agg", "vid_wgh": "nrm"}, {}),
    "none_gem": ({"vid_cont": "none", "vid_inp": "agg", "txt_pro": "gem",
                  "txt_wgh": "none", "vid_wgh": "nrm"}, {}),
    "mxp_ordr": ({"txt_agg": "bertftnmxp", "pos_enc": "ordr",
                  "out_tok": "mnp"}, {}),
    "frozen": ({"txt_agg": "bertfrz", "txt_inp": "bertfrz"}, {}),
    "wo2v_vlad": ({"txt_agg": "vlad", "txt_inp": "wo2vfrz"}, {}),
}


def make_workspace(root):
  """The JAX matrix's corpus (10 videos, 4 test, 2 captions each) under
  ``root``, its vocab and a seeded 16-wide word2vec text file over the
  corpus's words: (data_dir, the environment that names both)."""
  data_dir = synthetic.generate(root, num_videos=10, num_test=4,
                                experts={"rgb": 2048, "s3d": 1024},
                                captions_per_video=2)
  words = sorted(set(synthetic.TOPICS + synthetic.FILLER))
  rng = np.random.RandomState(0)
  lines = [f"{len(words)} 16"] + [
      f"{w} " + " ".join(f"{x:.4f}" for x in rng.randn(16)) for w in words]
  vectors = root / "vectors.txt"
  vectors.write_text("\n".join(lines) + "\n")
  return data_dir, {"MMT_TPU_BERT_VOCAB": str(root / "vocab.txt"),
                    "MMT_TPU_WORD_VECTORS": str(vectors)}


@pytest.fixture(scope="module")
def workspace(tmp_path_factory):
  """make_workspace's corpus, with its environment for the module's
  tests."""
  root = tmp_path_factory.mktemp("torch_matrix")
  data_dir, env = make_workspace(root)
  before = {k: os.environ.get(k) for k in env}
  os.environ.update(env)
  yield root, data_dir
  for key, value in before.items():
    if value is None:
      os.environ.pop(key, None)
    else:
      os.environ[key] = value


def case_config(root, data_dir, exp_dir, name, epochs=1):
  cfg = make_config(root, data_dir, exp_dir)
  cfg["trainer"].update({"epochs": epochs, "max_samples_per_epoch": 8})
  arch, top = MATRIX[name]
  cfg["arch"]["args"].update(arch)
  cfg.update(top)
  return cfg


def write_config(root, name, cfg):
  path = root / f"{name}.json"
  path.write_text(json.dumps(cfg))
  return path


def results(exp_dir):
  with open(pathlib.Path(exp_dir) / "exp_results.json") as f:
    return json.load(f)["perfs"][DS]


@pytest.mark.parametrize("name", sorted(MATRIX))
def test_matrix_case_trains_through_the_cli(workspace, tmp_path, name):
  root, data_dir = workspace
  cfg = case_config(root, data_dir, tmp_path / name, name)
  trainer = cli.main(["--config", str(write_config(tmp_path, name, cfg)),
                      "--device", "cpu"])
  assert 0 <= results(tmp_path / name)["t2v_metrics/R1/final_eval"] <= 100
  assert (tmp_path / name / "exp_completed_flag.txt").exists()
  assert trainer.n_steps == 2
  if name == "frozen":
    # The frozen text tower holds its initial weights (the trainer's init
    # is the config seed's generator); the video tower trained.
    kwargs, _ = cenet_kwargs_from_arch_args(cfg["arch"]["args"],
                                            trainer.tokenizer)
    init = CENet(expert_dims=trainer.model.expert_dims, device="cpu",
                 **kwargs).init_weights(torch.Generator().manual_seed(0))
    init = init.state_dict()
    for key, value in trainer.model.state_dict().items():
      if key.startswith("txt_bert."):
        assert torch.equal(value, init[key]), key
    key = "vid_bert.encoder.layer.0.attention.self.query.weight"
    assert not torch.equal(trainer.model.state_dict()[key], init[key])
    assert all(not p.requires_grad
               for p in trainer.model.txt_bert.parameters())
  if name == "wo2v_vlad":
    # The word vectors were loaded ([PAD] / [UNK] rows zero) and stayed
    # frozen (wo2vfrz).
    table = trainer.model.word_embeddings.word_embeddings.weight
    assert not table[:2].any()
    np.testing.assert_array_equal(table.detach().numpy(),
                                  trainer.tokenizer.weights)
  if name == "infonce_ranger":
    from mmt_tpu_torch.train.optim import Ranger
    assert isinstance(trainer.optimizer, Ranger)


def test_ranger_state_resumes_through_the_cli(workspace, tmp_path):
  """Ranger's state (step, moments, slow buffer) goes through the
  checkpoint (include_optim_in_ckpts) and comes back on --resume."""
  from mmt_tpu_torch import config as config_lib
  from mmt_tpu_torch.train import checkpoint as ckpt_lib
  root, data_dir = workspace
  exp = tmp_path / "ranger"
  cfg = case_config(root, data_dir, exp, "infonce_ranger")
  cli.main(["--config", str(write_config(tmp_path, "ranger", cfg)),
            "--device", "cpu"])
  saved = ckpt_lib.load_checkpoint(exp / "checkpoint-epoch1.pth")
  ns = argparse.Namespace(config=None, resume=str(exp),
                          load_checkpoint=None, only_eval=False,
                          txt_bert_init=None)
  resumed = cli.build_trainer(config_lib.from_args(ns), device="cpu")
  assert resumed.start_epoch == 2 and resumed.n_steps == 2
  got = resumed.optimizer.state_dict()["state"]
  assert got.keys() == saved["optimizer"]["state"].keys()
  for i, entry in saved["optimizer"]["state"].items():
    assert set(entry) == {"step", "exp_avg", "exp_avg_sq", "slow_buffer"}
    for key, value in entry.items():
      assert torch.equal(got[i][key], value), (i, key)


def test_vid_wgh_emb_requires_bert(workspace, tmp_path):
  """vid_wgh='emb' without the video transformer is a config error, with
  the JAX package's message."""
  root, data_dir = workspace
  cfg = make_config(root, data_dir, tmp_path / "bad_emb")
  cfg["arch"]["args"].update(vid_cont="none", vid_inp="agg", vid_wgh="emb")
  with pytest.raises(ValueError, match="vid_wgh='emb'"):
    cli.main(["--config", str(write_config(tmp_path, "bad_emb", cfg)),
              "--device", "cpu"])


# ---------------------------------------------------------------------------
# Whole-run parity with the JAX CLI, and serving
# ---------------------------------------------------------------------------

# Adam's eps in the parity runs.  At the config's 1e-8, Adam turns the
# rounding noise of the gradients that are zero in exact arithmetic (the
# biases in front of a train-mode BatchNorm: text_GU / video_GU
# cg.fc.bias, f_reason_2.bias, and f_reason_1.bias where a unit is active
# on every row of the batch) into lr-sized steps that differ between any
# two runs (ROADMAP.md C, the zero-gradient trap): the port against itself
# from weights moved by one rounding already strays past the tolerances.
# At 1e-4 that noise moves a parameter by lr * 1e-5 while the real
# gradients still take normalized steps.
PARITY_EPS, CONFIG_EPS = 1e-4, 1e-8


def parity_config(root, data_dir, exp_dir, name, eps=PARITY_EPS):
  """The case's config over 2 epochs, every dropout rate 0, the text
  tower drawn at initializer_range 0.5 (the BatchNorm conditioning trap,
  tests/test_torch_trainer.py:parity_config) and Adam's eps ``eps``."""
  cfg = case_config(root, data_dir, exp_dir, name, epochs=2)
  args = cfg["arch"]["args"]
  for tower in ("vid_bert_params", "txt_bert_params"):
    args[tower]["hidden_dropout_prob"] = 0.0
    args[tower]["attention_probs_dropout_prob"] = 0.0
  args["text_bert_geometry"]["initializer_range"] = 0.5
  cfg["optimizer"]["args"]["eps"] = eps
  return cfg


def jax_and_port_runs(workspace, exps, name, eps):
  """The JAX CLI's 2-epoch run and the port's CLI from its initial
  weights (saved as exps/init.pth); returns both trainers and the init."""
  import jax
  import train as jax_cli
  from mmt_tpu import config as jax_config

  root, data_dir = workspace
  jax_path = write_config(exps, "jax", parity_config(
      root, data_dir, exps / "jax", name, eps))
  ns = argparse.Namespace(config=str(jax_path), resume=None,
                          load_checkpoint=None, only_eval=False,
                          txt_bert_init=None)
  jax_trainer = jax_cli.build_trainer(jax_config.from_args(ns))
  to_np = lambda tree: jax.tree_util.tree_map(np.asarray, tree)
  init = convert.state_dict_from_flax(to_np(jax_trainer.params),
                                      to_np(jax_trainer.batch_stats))
  jax_trainer.train()
  jax_trainer.evaluate()
  port_trainer = port_run(workspace, exps, "port", init, name, eps)
  return jax_trainer, port_trainer, init


def port_run(workspace, exps, run, state_dict, name, eps):
  """The port's CLI, 2 epochs of the parity config from ``state_dict``."""
  root, data_dir = workspace
  torch.save({"state_dict": state_dict}, exps / f"{run}.pth")
  path = write_config(exps, run, parity_config(root, data_dir, exps / run,
                                               name, eps))
  return cli.main(["--config", str(path), "--device", "cpu",
                   "--load_checkpoint", str(exps / f"{run}.pth")])


@pytest.fixture(scope="module", params=["coll", "wo2v_vlad"])
def parity(request, workspace, tmp_path_factory):
  name = request.param
  exps = tmp_path_factory.mktemp(f"parity_{name}")
  jax_trainer, port_trainer, init = jax_and_port_runs(workspace, exps, name,
                                                      PARITY_EPS)
  return name, jax_trainer, port_trainer, exps, init


def _epoch_losses(exp_dir):
  with open(exp_dir / "perf_log.txt") as f:
    return [json.loads(line)["loss"] for line in f]


def _sims(exp_dir):
  return np.load(exp_dir / "MSRVTT-test-sims.npy", allow_pickle=True)[()]


def test_parity_losses_sims_and_ranks(parity):
  name, jax_trainer, port_trainer, exps, init = parity
  # The JAX trainer's init loads strict into the port's CENet.
  port_trainer.model.load_state_dict(init, strict=True)
  want, got = _epoch_losses(exps / "jax"), _epoch_losses(exps / "port")
  assert len(got) == len(want) == 3
  np.testing.assert_allclose(got, want, rtol=LOSS_RTOL, err_msg=name)
  assert port_trainer.n_steps == jax_trainer.n_steps == 4
  want, got = _sims(exps / "jax"), _sims(exps / "port")
  np.testing.assert_array_equal(got["query_masks"], want["query_masks"])
  np.testing.assert_allclose(got["sims"], want["sims"], rtol=0,
                             atol=SIMS_TOL, err_msg=name)
  gaps = np.diff(np.sort(want["sims"], axis=1), axis=1).min(axis=1)
  clear = gaps > SIMS_TOL
  assert clear.any()
  ranks = [ranking.t2v_ranks(torch.from_numpy(s["sims"])).numpy()
           for s in (want, got)]
  np.testing.assert_array_equal(ranks[1][clear], ranks[0][clear])


def test_serving_matches_jax(parity):
  """The JAX-trained model served by the port (its .msgpack through
  serve.load_model_and_loader) against mmt_tpu/serving.py."""
  import jax
  from mmt_tpu import serving as jax_serving
  from test_torch_serving import assert_hits_match
  name, jax_trainer, _, exps, _ = parity
  to_np = lambda tree: jax.tree_util.tree_map(np.asarray, tree)
  variables = {"params": to_np(jax_trainer.params),
               "batch_stats": to_np(jax_trainer.batch_stats)}
  jax_entry = jax_trainer.data_loaders["final_eval_sets"][0]
  jax_index = jax_serving.RetrievalIndex.build(
      jax_trainer.model, variables, jax_entry["loader"],
      dataset=jax_entry["dataset"].datasets[0])
  model, tokenizer, entry, max_words = serve.load_model_and_loader(
      exps / "jax.json", exps / "jax" / "trained_model.msgpack", "cpu")
  assert isinstance(model, CENet)
  if name == "wo2v_vlad":
    assert type(tokenizer).__name__ == "WeTokenizer"
  index = serving.RetrievalIndex.build(
      model, entry["loader"], dataset=entry["dataset"].datasets[0])
  np.testing.assert_allclose(index.vid_embds, jax_index.vid_embds, rtol=0,
                             atol=SERVE_TOL)
  np.testing.assert_allclose(index.vid_weights, jax_index.vid_weights,
                             rtol=0, atol=SERVE_TOL)
  assert index.video_ids == jax_index.video_ids
  want = jax_serving.RetrievalEngine(
      jax_trainer.model, variables, jax_trainer.tokenizer, jax_index,
      max_text_words=max_words).search(QUERIES, 3)
  got = serving.RetrievalEngine(model, tokenizer, index,
                                max_text_words=max_words).search(QUERIES, 3)
  assert_hits_match(want, got, SERVE_TOL)


def parity_gaps(exp_a, exp_b):
  """Largest relative gap of the trained epochs' mean losses, largest
  absolute gap of the final sims."""
  a, b = _epoch_losses(exp_a)[1:], _epoch_losses(exp_b)[1:]
  loss = float(np.max(np.abs(np.subtract(a, b)) / np.abs(b)))
  return loss, float(np.abs(_sims(exp_a)["sims"] - _sims(exp_b)["sims"]).max())


@pytest.mark.parametrize("name", ["coll", "wo2v_vlad"])
def test_parity_gap_at_the_configs_eps_is_rounding_sized(workspace,
                                                        tmp_path_factory,
                                                        name):
  """At Adam's eps of the config (1e-8) the JAX CLI lies no farther from
  the port than the parity tolerance or the port from itself with its
  initial weights moved by one rounding (each weight times 1 + u,
  |u| <= 2^-24; three draws), whichever is larger."""
  from test_torch_trainer import moved_by_one_rounding
  exps = tmp_path_factory.mktemp(f"eps_{name}")
  _, _, init = jax_and_port_runs(workspace, exps, name, CONFIG_EPS)
  moved = []
  for draw in range(3):
    port_run(workspace, exps, f"moved{draw}",
             moved_by_one_rounding(init, draw), name, CONFIG_EPS)
    moved.append(parity_gaps(exps / f"moved{draw}", exps / "port"))
  loss_moved, sims_moved = map(max, zip(*moved))
  loss_jax, sims_jax = parity_gaps(exps / "port", exps / "jax")
  assert loss_jax <= max(LOSS_RTOL, loss_moved), (loss_jax, moved)
  assert sims_jax <= max(SIMS_TOL, sims_moved), (sims_jax, moved)
