"""The port's weight carry-over, ranks, dispatch rule and independence
from JAX, each against the JAX package where it has a counterpart."""

import dataclasses
import importlib.util
import inspect
import pathlib
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

import __graft_entry__
from mmt_tpu import config as jax_config
from mmt_tpu import experts as jax_experts
from mmt_tpu.models.cenet import CENet as FlaxCENet
from mmt_tpu.train import metrics as jax_metrics
from mmt_tpu_torch import _build, config, convert, experts, flagship
from mmt_tpu_torch.models.cenet import CENet
from mmt_tpu_torch.ops import ffn, ranking, similarity
from tests.conftest import make_batch

REPO = pathlib.Path(__file__).resolve().parent.parent


def _convert_checkpoint_module():
  spec = importlib.util.spec_from_file_location(
      "convert_checkpoint", REPO / "scripts" / "convert_checkpoint.py")
  mod = importlib.util.module_from_spec(spec)
  spec.loader.exec_module(mod)
  return mod


def test_state_dict_matches_export_state_dict(tiny_arch):
  model = FlaxCENet(**tiny_arch)
  batch = make_batch(tiny_arch["expert_dims"], b=2, k=1, t=5, l=3)
  variables = model.init(
      {"params": jax.random.PRNGKey(3), "dropout": jax.random.PRNGKey(4)},
      batch, train=False)
  params = jax.tree_util.tree_map(np.asarray, variables["params"])
  stats = jax.tree_util.tree_map(np.asarray, variables["batch_stats"])
  want, unexported = _convert_checkpoint_module().export_state_dict(
      params, stats, with_pooler=False)
  assert not unexported
  got = convert.state_dict_from_flax(params, stats)
  skip = lambda d: {k for k in d if not k.endswith("num_batches_tracked")}
  assert skip(got) == skip(want)
  for name in skip(want):
    np.testing.assert_array_equal(got[name].numpy(), want[name],
                                  err_msg=name)
  # ... and it is exactly the port's state dict.
  port = CENet(**tiny_arch, device="cpu")
  port.load_state_dict(got, strict=True)
  assert set(port.state_dict()) == set(got)


def _ranked_case(v, cpv, seed):
  rng = np.random.RandomState(seed)
  # Values on a coarse grid, so ties are common.
  sims = (rng.randint(0, 6, (v * cpv, v)) / 4.0).astype(np.float32)
  masks = (rng.rand(v, cpv) > 0.3).astype(np.float32)
  masks[0] = 0.0          # a video with every caption slot masked
  masks[1] = 1.0
  return sims, masks


@pytest.mark.parametrize("v,cpv,seed", [(7, 1, 0), (9, 3, 1), (16, 2, 2)])
def test_ranks_match_numpy(v, cpv, seed):
  sims, masks = _ranked_case(v, cpv, seed)
  t = torch.from_numpy(sims)
  np.testing.assert_array_equal(ranking.t2v_ranks(t).numpy(),
                                jax_metrics._t2v_ranks_np(sims))
  np.testing.assert_array_equal(
      ranking.v2t_ranks(t, torch.from_numpy(masks)).numpy(),
      jax_metrics._v2t_ranks_np(sims, masks))


def test_port_imports_no_jax():
  code = (
      "import sys, torch\n"
      "before = set(sys.modules)\n"
      "from mmt_tpu_torch import bench, evaluate, flagship\n"
      "arch = flagship.flagship_arch(tiny=True)\n"
      "model = flagship.flagship_model(device='cpu', tiny=True,\n"
      "                                compute_dtype=torch.float32)\n"
      "batch = flagship.batch_to_torch(flagship.make_batch(\n"
      "    arch['expert_dims'], 3, max_expert_tokens=4, max_text_words=6,\n"
      "    vocab=512), 'cpu')\n"
      "res = evaluate.retrieval_eval(model, [batch])\n"
      "assert res['sims'].shape == (3, 3)\n"
      "res = evaluate.retrieval_eval(model, [batch], fused=True)\n"
      "assert 'sims' not in res and len(res['t2v_metrics']['cols']) == 3\n"
      "from mmt_tpu_torch import serve, serving\n"
      "with torch.no_grad():\n"
      "  txt = model.embed_text(batch['token_ids'])\n"
      "  vid = model.embed_video(batch)\n"
      "  for q in (None, 'int8'):\n"
      "    staged = serving.stage_index(vid['vid_embds'].numpy(),\n"
      "                                 vid['vid_weights'].numpy(), 'cpu', q)\n"
      "    sims = serving.index_similarity(txt['text_embds'][:, 0],\n"
      "                                    txt['text_weights'][:, 0],\n"
      "                                    staged, 3, q)\n"
      "    assert sims.shape[0] == 3\n"
      "import os\n"
      "os.environ.update(BENCH_VIDEOS='4', BENCH_BATCH='2')\n"
      "from mmt_tpu_torch import int8_quality, profile_eval\n"
      "res = profile_eval.profile('eval', 1, 'cpu', tiny=True)\n"
      "assert res['rows'] and res['idle'] is None\n"
      "rep = int8_quality.main(['--videos', '40', '--queries', '8',\n"
      "                         '--dim', '16', '--device', 'cpu'])\n"
      "assert rep['videos'] == 40 and rep['backend'] == 'cpu'\n"
      "new = set(sys.modules) - before\n"
      "bad = sorted(m for m in new if m.split('.')[0] in\n"
      "             ('jax', 'jaxlib', 'flax', 'optax', 'mmt_tpu'))\n"
      "print('BAD', bad)\n"
      "assert not bad, bad\n")
  proc = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                        capture_output=True, text=True, timeout=300)
  assert proc.returncode == 0, proc.stdout + proc.stderr
  assert "BAD []" in proc.stdout


def test_entry_points_default_to_the_card(tiny_arch):
  from mmt_tpu_torch import bench
  from mmt_tpu_torch.train import metrics
  for fn in (CENet.__init__, metrics.fused_retrieval_metrics,
             bench.staged_flagship, bench.build_full_eval,
             bench.build_streaming_eval, bench.bench_train_step):
    assert inspect.signature(fn).parameters["device"].default == "cuda", fn
  if torch.cuda.is_available():
    assert next(CENet(**tiny_arch).parameters()).is_cuda
  else:
    with pytest.raises((AssertionError, RuntimeError)):
      CENet(**tiny_arch)


def test_cpu_tensors_take_the_plain_versions():
  rng = np.random.RandomState(0)
  h, i = 32, 64
  x, w1, w2 = (torch.from_numpy(rng.randn(*s).astype(np.float32))
               for s in ((5, h), (i, h), (h, i)))
  b1, b2, g, b = (torch.from_numpy(rng.randn(n).astype(np.float32))
                  for n in (i, h, h, h))
  before = ffn.ffn_block_cuda.launches
  got = ffn.ffn_block(x, w1, b1, w2, b2, g, b, eps=1e-12,
                      compute_dtype=torch.float32)
  want = ffn.ffn_block_plain(x, w1, b1, w2, b2, g, b, eps=1e-12,
                             compute_dtype=torch.float32)
  torch.testing.assert_close(got, want, rtol=0, atol=0)
  assert ffn.ffn_block_cuda.launches == before
  with pytest.raises(ValueError, match="CUDA"):
    ffn.ffn_block_cuda(x, w1, b1, w2, b2, g, b, eps=1e-12,
                       compute_dtype=torch.float32)

  t, v = torch.randn(4, 6), torch.randn(3, 6)
  tw, vw = torch.rand(4, 2), torch.rand(3, 2)
  before = similarity.sim_cuda.launches
  sims = similarity.moe_similarity(t.view(4, 2, 3), v.view(3, 2, 3), tw, vw,
                                   merge="indep")
  assert sims.shape == (4, 3)
  assert similarity.sim_cuda.launches == before
  with pytest.raises(ValueError, match="CUDA"):
    similarity.sim_cuda(t, v, tw, vw)


def test_build_without_nvcc_raises(monkeypatch, tmp_path):
  monkeypatch.setattr(_build.shutil, "which", lambda name: None)
  monkeypatch.setenv("CUDA_HOME", str(tmp_path / "no-cuda"))
  monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
  monkeypatch.setattr(_build, "_lib", None)
  with pytest.raises(RuntimeError, match="nvcc not found"):
    _build.load_library()
  assert not (tmp_path / "build").exists()


def test_copied_config_and_flagship_batch_match_jax():
  assert (dataclasses.asdict(config.BertParams()) ==
          dataclasses.asdict(jax_config.BertParams()))
  assert (dataclasses.asdict(config.TEXT_BERT_BASE_CASED) ==
          dataclasses.asdict(jax_config.TEXT_BERT_BASE_CASED))
  cfg = {"experts": {"face_dim": 512, "modalities": flagship.MODALITIES}}
  assert experts.compute_dims(cfg) == jax_experts.compute_dims(cfg)

  _, want = __graft_entry__._flagship_model_and_batch(batch_size=3,
                                                      tiny=True)
  arch = flagship.flagship_arch(tiny=True)
  got = flagship.make_batch(arch["expert_dims"], 3, vocab=512)
  assert got.keys() == want.keys()
  for key in got:
    if isinstance(got[key], dict):
      for mod in got[key]:
        np.testing.assert_array_equal(got[key][mod], want[key][mod])
    else:
      np.testing.assert_array_equal(got[key], want[key])


def test_non_flagship_switch_raises(tiny_arch):
  """Every switch value the JAX package accepts builds (the parity of
  each is tests/test_torch_cenet_switches.py); an unknown value raises
  ValueError, an unknown argument TypeError."""
  CENet(**tiny_arch, device="cpu", vid_cont="coll", vid_inp="agg")
  with pytest.raises(ValueError, match="vid_cont"):
    CENet(**tiny_arch, device="cpu", vid_cont="bogus")
  with pytest.raises(TypeError):
    CENet(**tiny_arch, device="cpu", no_such_switch=1)
