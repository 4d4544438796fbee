"""A user-registered expert and the reference's last two units, in the
port against the JAX package.

``register_expert`` in both registries (a fixture removes the entry
again); ``compute_dims`` and ``CENet.video_seq_len`` equal in both
packages, the port's assembled video sequence as long as
``video_seq_len`` says; an expert whose token-type index lies outside the
video tower's table raises in the port (flax's lookup gives NaN rows,
ROADMAP C8); the CENet eval forward with the user expert (fp32, 1e-4);
``MimicCEGatedEmbeddingUnit`` in eval and train mode (outputs 1e-5,
BatchNorm buffers 1e-6) and ``GatedLinearUnit`` (1e-6), each from the
same seeded numpy inputs and the JAX parameters; and a whole 2-epoch run
of the port's CLI with the user expert against the JAX CLI's
(tests/test_torch_trainer.py's parity rules: loss 1e-4 relative, sims
1e-4, equal ranks).
"""

import pathlib
import sys

import flax.linen as flax_nn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mmt_tpu import experts as jax_experts
from mmt_tpu.models import components as jax_components
from mmt_tpu.models.cenet import CENet as FlaxCENet
from mmt_tpu_torch import convert, experts
from mmt_tpu_torch.data import synthetic
from mmt_tpu_torch.flagship import batch_to_torch
from mmt_tpu_torch.models import components
from mmt_tpu_torch.models.cenet import CENet
from mmt_tpu_torch.ops import ranking
from tests.conftest import make_batch

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent))
import test_torch_trainer as trainer_tests  # noqa: E402

USER = "user_clip"
USER_DIM, USER_IDX = 40, 10     # idx 10: unused by rgb (5) and s3d (1)
# Adam's eps in the whole-run parity, as tests/test_torch_config_matrix.py
# takes it (ROADMAP C4, the zero-gradient trap): at the config's 1e-8 the
# rounding noise of the biases in front of the train-mode BatchNorms, one
# more of them with each expert, becomes lr-sized steps that differ
# between any two runs: with the user expert the final sims of the two
# CLIs then differ past SIMS_TOL, as the port's own do from an init moved
# by one rounding.
PARITY_EPS = 1e-4


@pytest.fixture
def user_expert():
  """USER registered in both packages' registries for the test only."""
  specs = [mod.ExpertSpec(USER, USER_DIM, USER_IDX, feat_width=1.0)
           for mod in (experts, jax_experts)]
  experts.register_expert(specs[0])
  jax_experts.register_expert(specs[1])
  yield specs[0]
  experts.EXPERT_REGISTRY.pop(USER)
  jax_experts.EXPERT_REGISTRY.pop(USER)


def _dims(package, modalities):
  return package.compute_dims({"experts": {"modalities": modalities,
                                           "face_dim": 512}})


def test_register_expert_and_compute_dims(user_expert):
  for mods in (["rgb", "s3d"], [USER, "s3d", "rgb"], ["face", USER]):
    assert _dims(experts, mods) == _dims(jax_experts, mods)
  assert _dims(experts, [USER]) == {USER: {"dim": USER_DIM,
                                           "idx": USER_IDX}}
  assert experts.EXPERT_REGISTRY[USER] == user_expert


def test_the_fixture_leaves_no_entry():
  assert USER not in experts.EXPERT_REGISTRY
  assert USER not in jax_experts.EXPERT_REGISTRY
  with pytest.raises(KeyError, match=USER):
    _dims(experts, [USER])


@pytest.mark.parametrize("with_user", [False, True])
@pytest.mark.parametrize("vid_inp", ["agg", "temp", "both", "all"])
def test_video_seq_len(user_expert, tiny_arch, vid_inp, with_user):
  """video_seq_len equals the JAX module's at two lengths; where the
  port's video tower runs (every input but 'temp', which has no
  aggregated token to read), the sequence it assembles is that long."""
  mods = ["rgb", "s3d"] + [USER] * with_user
  arch = dict(tiny_arch, expert_dims=_dims(experts, mods), vid_inp=vid_inp)
  model = CENet(**arch, device="cpu").eval()
  jax_model = FlaxCENet(**dict(arch, expert_dims=_dims(jax_experts, mods)))
  for length in (5, 30):
    assert model.video_seq_len(length) == jax_model.video_seq_len(length)
  if vid_inp == "temp":
    return
  seen = []
  model.vid_bert.register_forward_pre_hook(
      lambda mod, args: seen.append(args[0].shape[1]))
  batch = batch_to_torch(make_batch(arch["expert_dims"], b=2, k=1, l=5),
                         "cpu")
  with torch.inference_mode():
    model.embed_video(batch)
  assert seen == [model.video_seq_len(5)]


def test_user_expert_outside_the_type_table_raises(tiny_arch):
  """An idx at or past type_vocab_size (19): flax's nn.Embed looks it up
  as a NaN row; the port refuses the model, naming the expert."""
  dims = {"rgb": {"dim": 64, "idx": 5}, USER: {"dim": USER_DIM, "idx": 19}}
  with pytest.raises(ValueError, match=f"'{USER}': 19"):
    CENet(**dict(tiny_arch, expert_dims=dims), device="cpu")
  embed = flax_nn.Embed(19, 4)
  ids = jnp.array([3, 19])
  rows = np.asarray(embed.apply(embed.init(jax.random.PRNGKey(0), ids), ids))
  assert np.isfinite(rows[0]).all() and np.isnan(rows[1]).all()


def test_user_expert_eval_forward_matches_flax(user_expert, tiny_arch):
  """The CENet eval forward with the user expert beside rgb and s3d,
  fp32, on the JAX parameters: every output within 1e-4."""
  mods = ["rgb", "s3d", USER]
  arch = dict(tiny_arch, expert_dims=_dims(jax_experts, mods))
  batch = make_batch(arch["expert_dims"], b=3, k=2, t=7, l=5, seed=3)
  flax_model = FlaxCENet(**arch)
  variables = jax.jit(lambda rngs: flax_model.init(rngs, batch))(
      {"params": jax.random.PRNGKey(0), "dropout": jax.random.PRNGKey(1)})
  want = jax.jit(lambda v: flax_model.apply(v, batch))(variables)
  model = CENet(**dict(arch, expert_dims=_dims(experts, mods)),
                device="cpu").eval()
  to_np = lambda tree: jax.tree_util.tree_map(np.asarray, tree)
  model.load_state_dict(convert.state_dict_from_flax(
      to_np(variables["params"]), to_np(variables["batch_stats"])),
      strict=True)
  with torch.inference_mode():
    got = model(batch_to_torch(batch, "cpu"))
  for key in ("text_embds", "vid_embds", "text_weights", "vid_weights"):
    assert got[key].shape == want[key].shape, key
    np.testing.assert_allclose(got[key].numpy(), np.asarray(want[key]),
                               rtol=1e-4, atol=1e-4, err_msg=key)
  assert got["vid_weights"].shape[-1] == 3


# ---------------------------------------------------------------------------
# The reference's units no config uses
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("use_bn", [True, False])
def test_mimic_ce_unit_matches_flax(use_bn):
  """Eval mode on non-trivial running statistics, then one train-mode
  call (batch moments, updated buffers)."""
  rng = np.random.RandomState(11)
  dim = 24
  x = rng.randn(6, dim).astype(np.float32)
  unit = jax_components.MimicCEGatedEmbeddingUnit(dim, use_bn)
  variables = jax.tree_util.tree_map(
      np.asarray, unit.init(jax.random.PRNGKey(2), x))
  stats = variables.get("batch_stats", {})
  if use_bn:
    bn = stats["cg"]["batch_norm"]["bn"]
    bn["mean"] = (rng.randn(dim) * 0.1).astype(np.float32)
    bn["var"] = (np.abs(rng.randn(dim)) + 0.5).astype(np.float32)
  port = components.MimicCEGatedEmbeddingUnit(dim, use_bn=use_bn,
                                              device="cpu")
  port.load_state_dict(convert.module_state_dict_from_flax(
      variables["params"], stats), strict=True)
  tx = torch.from_numpy(x)

  want = unit.apply({"params": variables["params"], "batch_stats": stats}, x)
  with torch.no_grad():
    got = port(tx)
  np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                             atol=1e-5)

  want, updated = unit.apply(
      {"params": variables["params"], "batch_stats": stats}, x, train=True,
      mutable=["batch_stats"])
  with torch.no_grad():
    got = port(tx, train=True)
  np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                             atol=1e-5)
  if use_bn:
    bn = updated["batch_stats"]["cg"]["batch_norm"]["bn"]
    for leaf, buf in (("mean", port.cg.batch_norm.running_mean),
                      ("var", port.cg.batch_norm.running_var)):
      np.testing.assert_allclose(buf.numpy(), np.asarray(bn[leaf]),
                                 rtol=1e-6, atol=1e-6, err_msg=leaf)


def test_gated_linear_unit_matches_flax():
  rng = np.random.RandomState(12)
  x, mask = (rng.randn(5, 16).astype(np.float32) * 3 for _ in range(2))
  unit = jax_components.GatedLinearUnit()
  want = unit.apply(unit.init(jax.random.PRNGKey(0), x, mask), x, mask)
  port = components.GatedLinearUnit()
  assert not list(port.parameters())
  got = port(torch.from_numpy(x), torch.from_numpy(mask))
  np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6,
                             atol=1e-6)


# ---------------------------------------------------------------------------
# Whole-run parity of the CLIs with the user expert
# ---------------------------------------------------------------------------


def test_cli_parity_with_a_user_expert(user_expert, tmp_path, monkeypatch):
  """tests/test_torch_trainer.py's whole-run parity (2 epochs, every
  dropout rate 0, the text tower at initializer_range 0.5, the port from
  the JAX trainer's converted init) with Adam's eps PARITY_EPS, on a
  corpus and config that hold the user expert beside rgb and s3d."""
  data_dir = synthetic.generate(
      tmp_path, num_videos=14, num_test=6,
      experts={"rgb": 2048, "s3d": 1024, USER: USER_DIM},
      captions_per_video=3)
  monkeypatch.setenv("MMT_TPU_BERT_VOCAB", str(tmp_path / "vocab.txt"))
  parity_config = trainer_tests.parity_config

  def with_user(*args, **kw):
    cfg = parity_config(*args, **kw)
    cfg["experts"]["modalities"].append(USER)
    cfg["optimizer"]["args"]["eps"] = PARITY_EPS
    return cfg

  monkeypatch.setattr(trainer_tests, "parity_config", with_user)
  exps = tmp_path / "exps"
  exps.mkdir()
  jax_trainer, port_trainer, init = trainer_tests.jax_and_port_runs(
      (tmp_path, data_dir), exps, trainer_tests.PARITY_INIT_RANGE)
  assert any(f".{USER}." in name for name in init)
  assert port_trainer.model.modalities == ["rgb", "s3d", USER]

  losses = [trainer_tests._epoch_losses(exps / n) for n in ("jax", "port")]
  assert len(losses[1]) == len(losses[0]) == 3
  np.testing.assert_allclose(losses[1], losses[0],
                             rtol=trainer_tests.LOSS_RTOL)
  want, got = (trainer_tests._sims(exps / n) for n in ("jax", "port"))
  np.testing.assert_allclose(got["sims"], want["sims"], rtol=0,
                             atol=trainer_tests.SIMS_TOL)
  gaps = np.diff(np.sort(want["sims"], axis=1), axis=1).min(axis=1)
  clear = gaps > trainer_tests.SIMS_TOL
  assert clear.any()
  ranks = [ranking.t2v_ranks(torch.from_numpy(s["sims"])).numpy()
           for s in (want, got)]
  np.testing.assert_array_equal(ranks[1][clear], ranks[0][clear])
