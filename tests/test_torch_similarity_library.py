"""The exact serving engine scores as the JAX engine does: outside the
similarity kernel.

``ops.similarity.moe_similarity(prefer_kernel=False)`` (the library
route, two fp32 ``torch.mm``s and the zero guard) against the JAX
package's ``_xla_moe_similarity``, the route its serving engine takes
(``prefer_pallas = False``, mmt_tpu/serving.py:307-315), and the exact
engine, whole and on 3 shards, searching with ``MoESimilarity.apply``
made to raise: the serving path never enters the kernel route.  Scores
against the JAX einsum on the engine's own text embeddings and index.
fp32 throughout; tolerance 1e-5 (sum order).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mmt_tpu.ops import similarity as jax_similarity
from mmt_tpu_torch import flagship, serving, tokenization
from mmt_tpu_torch.ops import similarity

TOL = 1e-5
WORDS = "a man cooking pasta dog park rain city soccer night".split()
QUERIES = ["a man cooking pasta", "dog in the park at night", "rain city"]


def _inputs(q, v, m, d, seed, zero_rows=False):
  rng = np.random.RandomState(seed)
  te = rng.randn(q, m, d).astype(np.float32)
  ve = rng.randn(v, m, d).astype(np.float32)
  te /= np.linalg.norm(te, axis=-1, keepdims=True)
  ve /= np.linalg.norm(ve, axis=-1, keepdims=True)
  tw = rng.rand(q, m).astype(np.float32)
  vw = rng.rand(v, m).astype(np.float32)
  if zero_rows:   # denominators of exactly 0: the guard
    tw[1] = 0.0
    vw[2] = 0.0
  return te, ve, tw, vw


@pytest.mark.parametrize("q,v,m,d,zero_rows",
                         [(5, 9, 7, 16, False), (4, 6, 2, 32, True)])
def test_library_route_matches_jax_einsum(q, v, m, d, zero_rows):
  args = _inputs(q, v, m, d, seed=q * v, zero_rows=zero_rows)
  want = np.asarray(jax_similarity._xla_moe_similarity(
      *map(jnp.asarray, args)))
  before = similarity.sim_cuda.launches
  got = similarity.moe_similarity(*map(torch.from_numpy, args),
                                  merge="indep", prefer_kernel=False)
  np.testing.assert_allclose(got.numpy(), want, rtol=TOL, atol=TOL)
  # 'avg' over the captions of a video, as the JAX function merges.
  caps = 2 if q % 2 == 0 else 1
  want_avg = np.asarray(jax_similarity.moe_similarity(
      *map(jnp.asarray, args), merge="avg", num_caps=caps,
      prefer_pallas=False))
  got_avg = similarity.moe_similarity(*map(torch.from_numpy, args),
                                      merge="avg", num_caps=caps,
                                      prefer_kernel=False)
  np.testing.assert_allclose(got_avg.numpy(), want_avg, rtol=TOL, atol=TOL)
  assert similarity.sim_cuda.launches == before


def test_library_route_is_not_the_kernel_route(monkeypatch):
  """prefer_kernel=False never calls MoESimilarity; None does."""
  args = tuple(map(torch.from_numpy, _inputs(3, 4, 2, 8, seed=1)))
  calls = []
  real = similarity.MoESimilarity.apply
  monkeypatch.setattr(similarity.MoESimilarity, "apply",
                      lambda *a: calls.append(1) or real(*a))
  lib = similarity.moe_similarity(*args, merge="indep", prefer_kernel=False)
  assert calls == []
  kern = similarity.moe_similarity(*args, merge="indep")
  assert calls == [1]
  np.testing.assert_allclose(lib.numpy(), kern.numpy(), rtol=TOL, atol=TOL)


@pytest.fixture(scope="module")
def engines(tmp_path_factory):
  vocab = tmp_path_factory.mktemp("library_route") / "vocab.txt"
  vocab.write_text("\n".join(["[PAD]", "[UNK]", "[CLS]", "[SEP]", "[MASK]"]
                             + WORDS) + "\n")
  tok = tokenization.WordPieceTokenizer(str(vocab))
  model = flagship.flagship_model(device="cpu", compute_dtype=torch.float32,
                                  tiny=True, seed=4)
  m = len(model.expert_dims)
  ve, _, vw, _ = _inputs(11, 1, m, model.same_dim, seed=9)
  vw /= vw.sum(-1, keepdims=True)
  index = serving.RetrievalIndex(ve, vw, [f"v{i}" for i in range(11)],
                                 [""] * 11)
  return model, {n: serving.RetrievalEngine(model, tok, index, mesh=mesh)
                 for n, mesh in (("whole", None), ("3 shards", ["cpu"] * 3))}


@pytest.mark.parametrize("name", ["whole", "3 shards"])
def test_exact_engine_never_enters_the_kernel(engines, name, monkeypatch):
  model, engs = engines
  engine = engs[name]

  def refuse(*args):
    raise AssertionError("the serving path entered MoESimilarity")

  monkeypatch.setattr(similarity.MoESimilarity, "apply", refuse)
  hits = engine.search(QUERIES, topk=4)
  with torch.inference_mode():
    got = engine._similarities(QUERIES)[:, :len(engine.index)].numpy()
    out = model.embed_text(torch.from_numpy(engine.encode_queries(QUERIES)))
  want = np.asarray(jax_similarity._xla_moe_similarity(
      jnp.asarray(out["text_embds"][:, 0].numpy()),
      jnp.asarray(engine.index.vid_embds),
      jnp.asarray(out["text_weights"][:, 0].numpy()),
      jnp.asarray(engine.index.vid_weights)))
  np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL)
  for q, row in enumerate(hits):
    assert [h["video_id"] for h in row] == [
        f"v{i}" for i in np.argsort(-want[q], kind="stable")[:4]]
    np.testing.assert_allclose([h["score"] for h in row],
                               np.sort(want[q])[::-1][:4], rtol=TOL,
                               atol=TOL)
