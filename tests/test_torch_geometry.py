"""The other published geometries (ActivityNet, HowTo100M) in the port
against the JAX package.

- ``flagship.make_batch`` at each geometry bitwise equal to the batch of
  ``__graft_entry__._flagship_model_and_batch`` (the recipe
  scripts/bench_geometry.py feeds), tiny and full vocabulary.
- A tiny ActivityNet-shaped CENet (2 experts, 100 feature rows, 100
  caption words, a video position table of 102) with the same weights in
  both packages (a flax init carried over by ``state_dict_from_flax``):
  the eval sims (merge 'indep') within 1e-4, and the train-mode loss
  ('avg', max-margin 0.05 with fix_norm) with every dropout rate 0 within
  1e-6; fp32, the JAX package through its plain reference (XLA, no
  Pallas).  The JAX entry's tiny text tower has a 64-position table, which
  a 100-word caption reads past (JAX clamps the gather, torch raises); the
  port's tiny copy widens the table to the caption (``flagship_arch``), and
  the JAX CENet here is built from that same arch, so both read 100
  positions.
- ``bench_geometry``'s salted chunks: the draws of the JAX script's
  ``_model_and_staged`` on the ids and features; and the mask channel,
  which the JAX script salts too and the port keeps, changes neither the
  staged shapes nor the eval's kernel calls and their shapes.
"""

import jax
import numpy as np
import pytest
import torch

import __graft_entry__
from mmt_tpu.models.cenet import CENet as FlaxCENet
from mmt_tpu.models.cenet import similarity_from_outputs as flax_sims
from mmt_tpu.train import losses as flax_losses
from mmt_tpu_torch import bench_geometry, convert, evaluate, flagship
from mmt_tpu_torch.models.cenet import CENet, similarity_from_outputs
from mmt_tpu_torch.ops import ffn, similarity
from mmt_tpu_torch.train import losses

GEOMETRIES = sorted(bench_geometry.GEOMETRIES)
NO_DROPOUT = {"hidden_dropout_prob": 0.0, "attention_probs_dropout_prob": 0.0}
SIMS_TOL, LOSS_TOL = 1e-4, 1e-6


def _assert_batches_equal(got, want):
  assert got.keys() == want.keys()
  for key in got:
    if isinstance(got[key], dict):
      assert list(got[key]) == list(want[key]), key
      for mod in got[key]:
        np.testing.assert_array_equal(got[key][mod], want[key][mod])
    else:
      np.testing.assert_array_equal(got[key], want[key])


@pytest.mark.parametrize("tiny", [True, False])
@pytest.mark.parametrize("name", GEOMETRIES)
def test_batch_is_the_jax_entrys(name, tiny):
  geom = bench_geometry.keywords(bench_geometry.GEOMETRIES[name])
  _, want = __graft_entry__._flagship_model_and_batch(
      batch_size=3, tiny=tiny, **geom)
  dims = flagship.flagship_arch(
      tiny=tiny, **flagship.arch_keywords(geom))["expert_dims"]
  got = flagship.make_batch(dims, 3, **(dict(vocab=512) if tiny else {}),
                            **flagship.batch_keywords(geom))
  _assert_batches_equal(got, want)
  # The temporal ids index the caller's position table.
  assert max(float(t.max()) for t in got["features_t"].values()) < (
      geom["max_position_embeddings"] - 1)


def test_flagship_defaults_unchanged():
  _, want = __graft_entry__._flagship_model_and_batch(batch_size=2,
                                                      tiny=True)
  arch = flagship.flagship_arch(tiny=True)
  assert arch["vid_bert_params"]["max_position_embeddings"] == 32
  assert arch["text_bert_geometry"]["max_position_embeddings"] == 64
  _assert_batches_equal(flagship.make_batch(arch["expert_dims"], 2,
                                            vocab=512), want)


@pytest.fixture(scope="module")
def activitynet():
  """The tiny ActivityNet-shaped arch (dropout 0), a batch of 4, and a
  flax init of its weights, with the port's model carrying them."""
  geom = bench_geometry.keywords(bench_geometry.GEOMETRIES["activitynet"])
  arch = flagship.flagship_arch(tiny=True, **flagship.arch_keywords(geom))
  arch["vid_bert_params"] = {**arch["vid_bert_params"], **NO_DROPOUT}
  arch["txt_bert_params"] = dict(NO_DROPOUT)
  batch = flagship.make_batch(arch["expert_dims"], 4, vocab=512, seed=3,
                              **flagship.batch_keywords(geom))
  flax_model = FlaxCENet(**arch)
  variables = jax.tree_util.tree_map(np.asarray, flax_model.init(
      {"params": jax.random.PRNGKey(0), "dropout": jax.random.PRNGKey(1)},
      batch, train=False))
  model = CENet(**arch, device="cpu")
  model.load_state_dict(convert.state_dict_from_flax(
      variables["params"], variables["batch_stats"]), strict=True)
  return flax_model, variables, model, batch


def test_activitynet_eval_sims_match_jax(activitynet):
  flax_model, variables, model, batch = activitynet
  want = np.asarray(flax_sims(flax_model.apply(variables, batch,
                                               train=False), merge="indep"))
  with torch.inference_mode():
    got = similarity_from_outputs(
        model.eval()(flagship.batch_to_torch(batch, "cpu")), merge="indep")
  assert got.shape == (4, 4)
  np.testing.assert_allclose(got.numpy(), want, rtol=SIMS_TOL, atol=SIMS_TOL)


def test_activitynet_train_loss_matches_jax(activitynet):
  flax_model, variables, model, batch = activitynet
  out, _ = flax_model.apply(variables, batch, train=True,
                            rngs={"dropout": jax.random.PRNGKey(2)},
                            mutable=["batch_stats"])
  want = float(flax_losses.max_margin_ranking_loss(0.05, True)(
      flax_sims(out, merge="avg")))
  model.train()
  with torch.no_grad():
    got = losses.max_margin_ranking_loss(0.05, True)(similarity_from_outputs(
        model(flagship.batch_to_torch(batch, "cpu"), train=True,
              generator=torch.Generator().manual_seed(0)), merge="avg"))
  assert abs(float(got) - want) <= LOSS_TOL, (float(got), want)


def test_salted_chunks_are_the_jax_scripts():
  """Chunk c: the batch's ids + draw c (mod the vocabulary), its mask
  channel kept, each expert's features + its draw c x 0.01, from one
  RandomState(1) in the script's order (ids, then the experts)."""
  geom = bench_geometry.GEOMETRIES["howto100m"]
  model = flagship.flagship_model(device="cpu", compute_dtype=torch.float32,
                                  tiny=True, **flagship.arch_keywords(
                                      bench_geometry.keywords(geom)))
  chunks = bench_geometry.salted_chunks(model, geom, 2, 6, tiny=True)
  _, base = __graft_entry__._flagship_model_and_batch(
      batch_size=2, tiny=True, **bench_geometry.keywords(geom))
  rng = np.random.RandomState(1)
  ids = rng.randint(1, 1000, size=(3, 1, 1, 1, 1))
  feats = {m: rng.randn(3, 1, 1, 1).astype(np.float32) * 0.01
           for m in base["features"]}
  assert len(chunks) == 3
  for c, chunk in enumerate(chunks):
    np.testing.assert_array_equal(chunk["token_ids"][..., 0],
                                  (base["token_ids"][..., 0] + ids[c, 0])
                                  % 512)
    np.testing.assert_array_equal(chunk["token_ids"][..., 1],
                                  base["token_ids"][..., 1])
    for m, f in chunk["features"].items():
      np.testing.assert_array_equal(f, base["features"][m] + feats[m][c])
    np.testing.assert_array_equal(chunk["features_t"]["s3d"],
                                  base["features_t"]["s3d"])


def test_mask_salt_leaves_the_eval_work_unchanged(monkeypatch):
  """The JAX script adds each chunk's id salt to the mask channel too
  ((mask + salt) % 28996, a constant attention bias a caption); the port
  keeps the mask.  With the mask salted the JAX script's way, the staged
  chunks have the same shapes and types, and the eval makes the same B1
  and B4 calls (their plain versions on the CPU) at the same shapes and
  types, and returns sims of the same shape."""
  geom = bench_geometry.GEOMETRIES["activitynet"]
  model = flagship.flagship_model(device="cpu", compute_dtype=torch.float32,
                                  tiny=True, **flagship.arch_keywords(
                                      bench_geometry.keywords(geom)))
  chunks = bench_geometry.salted_chunks(model, geom, 2, 6, tiny=True)
  id_salt = np.random.RandomState(1).randint(1, 1000, size=len(chunks))
  jax_chunks = []
  for c, chunk in enumerate(chunks):
    tokens = chunk["token_ids"].copy()
    tokens[..., 1] = (tokens[..., 1] + id_salt[c]) % 28996
    jax_chunks.append(dict(chunk, token_ids=tokens))
  assert not np.array_equal(jax_chunks[0]["token_ids"],
                            chunks[0]["token_ids"])

  calls = []

  def recording(name, fn):
    def wrapped(*args, **kw):
      calls.append((name, [(tuple(a.shape), a.dtype) for a in args
                           if torch.is_tensor(a)]))
      return fn(*args, **kw)
    return wrapped

  monkeypatch.setattr(ffn, "ffn_block_plain",
                      recording("B1", ffn.ffn_block_plain))
  monkeypatch.setattr(similarity, "sim_plain",
                      recording("B4", similarity.sim_plain))

  def work(batches):
    staged = [flagship.batch_to_torch(b, "cpu") for b in batches]
    calls.clear()
    with torch.inference_mode():
      sims = evaluate.retrieval_eval(model, staged)["sims"]
    shapes = [(k, m, tuple(t.shape), t.dtype) for b in staged
              for k, v in b.items()
              for m, t in (v.items() if isinstance(v, dict) else [("", v)])
              if torch.is_tensor(t)]
    return shapes, list(calls), tuple(sims.shape)

  ours, theirs = work(chunks), work(jax_chunks)
  assert ours == theirs
  assert any(k == "token_ids" for k, *_ in ours[0])
  kinds = [name for name, _ in ours[1]]
  assert kinds.count("B4") == 1 and kinds.count("B1") >= len(chunks)
  assert ours[2] == (6, 6)
