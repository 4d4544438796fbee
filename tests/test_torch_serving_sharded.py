"""The port's serving index sharded over devices (``RetrievalEngine(
mesh=)``, ``parallel.local_mesh``) against its unsharded engine and the
JAX package's engine sharded over the 8-device virtual mesh
(``RetrievalEngine(mesh=data_mesh())``).

Both packages serve the same tiny CENet (a flax init carried over by
``convert.state_dict_from_flax``) and the same seeded index of 7 videos:
the port on 3 shards (7 is no multiple of 3: two pad rows), the JAX
package on 8 (one pad row).  The index's rows are L2-normalised random
vectors (numpy seed 5), so no two scores of a query tie.  Tolerances:
video ids exact; exact scores 1e-5, int8 scores 1e-4; the int8 codes and
scales bitwise; no pad row returned.
"""

import jax
import numpy as np
import pytest
import torch

from mmt_tpu.models.cenet import CENet as FlaxCENet
from mmt_tpu.parallel import mesh as jax_mesh
from mmt_tpu import serving as jax_serving
from mmt_tpu import tokenization as jax_tokenization
from mmt_tpu_torch import convert, serving, tokenization
from mmt_tpu_torch.models.cenet import CENet
from mmt_tpu_torch.parallel import mesh as mesh_lib
from tests.conftest import make_batch

EXACT_TOL, INT8_TOL = 1e-5, 1e-4
SHARDS = 3
WORDS = ("a man woman video of cooking soccer rain city dog cat car road "
         "kitchen pasta goal match street night day people playing music "
         "singing running water beach sun").split()
QUERIES = ["a video of cooking pasta", "a dog running on the beach",
           "people playing soccer at night", "rain in the city"]
MAX_WORDS = 12


@pytest.fixture(scope="module")
def world(tiny_arch, tmp_path_factory):
  """The tiny model in both packages (the same weights), their
  tokenizers over one vocab, and the seeded index of 7 videos."""
  vocab = tmp_path_factory.mktemp("sharded_serving") / "vocab.txt"
  vocab.write_text("\n".join(["[PAD]", "[UNK]", "[CLS]", "[SEP]", "[MASK]"]
                             + list(WORDS)) + "\n")
  flax_model = FlaxCENet(**tiny_arch)
  batch = make_batch(tiny_arch["expert_dims"], b=2, k=1, t=MAX_WORDS,
                     seed=1)
  variables = jax.tree_util.tree_map(np.asarray, flax_model.init(
      {"params": jax.random.PRNGKey(3), "dropout": jax.random.PRNGKey(4)},
      batch, train=False))
  model = CENet(**tiny_arch, device="cpu").eval()
  model.load_state_dict(convert.state_dict_from_flax(
      variables["params"], variables["batch_stats"]), strict=True)
  rng = np.random.RandomState(5)
  m, d = len(tiny_arch["expert_dims"]), tiny_arch["same_dim"]
  embds = rng.randn(10, m, d).astype(np.float32)
  embds /= np.linalg.norm(embds, axis=-1, keepdims=True)
  weights = rng.rand(10, m).astype(np.float32)
  weights /= weights.sum(-1, keepdims=True)
  return dict(model=model, flax_model=flax_model, variables=variables,
              tokenizer=tokenization.WordPieceTokenizer(str(vocab),
                                                        do_lower_case=True),
              jax_tokenizer=jax_tokenization.WordPieceTokenizer(
                  str(vocab), do_lower_case=True),
              embds=embds, weights=weights)


def make_index(world, rows, package=serving):
  rows = list(rows)
  return package.RetrievalIndex(world["embds"][rows].copy(),
                                world["weights"][rows].copy(),
                                [f"v{i}" for i in rows],
                                [f"p{i}" for i in rows])


def engine(world, index, **kw):
  return serving.RetrievalEngine(world["model"], world["tokenizer"], index,
                                 max_text_words=MAX_WORDS, **kw)


def jax_engine(world, index, **kw):
  return jax_serving.RetrievalEngine(
      world["flax_model"], world["variables"], world["jax_tokenizer"], index,
      max_text_words=MAX_WORDS, **kw)


def assert_same_hits(want, got, tol, ids):
  """Ids exact, ranks in order, scores within ``tol``, no pad row."""
  assert len(want) == len(got)
  for w_hits, g_hits in zip(want, got):
    assert [h["video_id"] for h in g_hits] == [h["video_id"] for h in w_hits]
    assert [h["rank"] for h in g_hits] == list(range(len(w_hits)))
    np.testing.assert_allclose([h["score"] for h in g_hits],
                               [h["score"] for h in w_hits], rtol=0,
                               atol=tol)
    assert all(h["video_id"] in ids for h in g_hits)
    assert len({h["video_id"] for h in g_hits}) == len(g_hits)


def no_ties(hits, tol):
  """The index's seeded rows give no tied scores (else ids could swap)."""
  for q_hits in hits:
    scores = np.sort([h["score"] for h in q_hits])
    assert (np.diff(scores) > 2 * tol).all(), scores


@pytest.mark.parametrize("quantize,tol", [(None, EXACT_TOL),
                                          ("int8", INT8_TOL)])
@pytest.mark.parametrize("topk", [3, 7, 9])
def test_sharded_matches_unsharded_and_jax(world, quantize, tol, topk):
  """7 videos on 3 shards (per-shard top-k of at most 3 rows, merged)
  against the unsharded engine and the JAX engine on its 8-device mesh;
  topk 9 is capped at the 7 videos, and no pad row comes back."""
  index = make_index(world, range(7))
  ids = set(index.video_ids)
  mesh = [torch.device("cpu")] * SHARDS
  want = engine(world, index, quantize=quantize).search(QUERIES, topk)
  no_ties(want, tol)
  got = engine(world, index, mesh=mesh, quantize=quantize).search(QUERIES,
                                                                  topk)
  assert_same_hits(want, got, tol, ids)
  assert all(len(h) == min(topk, 7) for h in got)
  jax_mesh_8 = jax_mesh.data_mesh()
  jax_hits = jax_engine(world, make_index(world, range(7), jax_serving),
                        mesh=jax_mesh_8, quantize=quantize).search(QUERIES,
                                                                   topk)
  assert_same_hits(jax_hits, got, tol, ids)


def test_int8_shards_hold_the_unsharded_codes(world):
  """Each shard stages its slice of the rows padded to 9: the real rows'
  int8 codes and scales bitwise the unsharded engine's and the JAX
  sharded engine's; the pad rows zero codes, unit scale, zero weights."""
  index = make_index(world, range(7))
  sharded = engine(world, index, mesh=["cpu"] * SHARDS, quantize="int8")
  whole = engine(world, index, quantize="int8")
  per = sharded._shard_rows
  assert per == 3 and [n for _, _, n in sharded._shards] == [3, 3, 1]
  codes, scales, weights = (torch.cat([staged[j][:per]
                                       for _, staged, _ in sharded._shards])
                            .numpy() for j in range(3))
  (_, (w_codes, w_scales, _), _), = whole._shards
  assert np.array_equal(codes[:7], w_codes[:7].numpy())
  assert np.array_equal(scales[:7], w_scales[:7].numpy())
  assert not codes[7:].any() and (scales[7:] == 1).all()
  assert not weights[7:].any()
  jax_q8, jax_scale, _ = (np.asarray(a) for a in jax_engine(
      world, make_index(world, range(7), jax_serving), mesh=jax_mesh.data_mesh(),
      quantize="int8")._dev_index)
  assert np.array_equal(codes[:7], jax_q8[:7])
  assert np.array_equal(scales[:7], jax_scale[:7])


def test_refresh_restages_every_shard(world):
  """extend / remove then refresh() re-pads and re-stages every shard:
  the live sharded engine answers as a fresh unsharded one (exact and
  int8), through 7 -> 10 (pad 2) -> 8 (pad 1) rows."""
  for quantize, tol in ((None, EXACT_TOL), ("int8", INT8_TOL)):
    index = make_index(world, range(7))
    live = engine(world, index, mesh=["cpu"] * SHARDS, quantize=quantize)
    index.extend(make_index(world, range(7, 10)))
    live.refresh()
    assert live._shard_rows == 4 and live.num_videos == 10
    assert_same_hits(engine(world, index, quantize=quantize).search(
        QUERIES, 10), live.search(QUERIES, 10), tol, set(index.video_ids))
    live.refresh(index.remove(["v0", "v5"]))
    assert live._shard_rows == 3 and live.num_videos == 8
    got = live.search(QUERIES, 8)
    assert_same_hits(engine(world, index, quantize=quantize).search(
        QUERIES, 8), got, tol, set(index.video_ids))
    assert not {"v0", "v5"} & {h["video_id"] for q in got for h in q}


def test_more_shards_than_videos_and_empty(world):
  """2 videos on 3 shards (a shard of pads only) and an emptied index."""
  index = make_index(world, range(2))
  got = engine(world, index, mesh=["cpu"] * SHARDS).search(QUERIES, 5)
  assert_same_hits(engine(world, index).search(QUERIES, 5), got, EXACT_TOL,
                   {"v0", "v1"})
  index.remove(["v0", "v1"])
  assert engine(world, index, mesh=["cpu"] * SHARDS).search(
      QUERIES[:1], 3) == [[]]


def test_local_mesh(monkeypatch):
  """The local cards, one shard each; None with one card or on the CPU
  (then --shard_index serves unsharded)."""
  assert mesh_lib.local_mesh("cpu") is None
  monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
  assert mesh_lib.local_mesh("cuda") is None
  monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)
  assert mesh_lib.local_mesh("cuda") == [torch.device("cuda", i)
                                         for i in range(4)]
  assert mesh_lib.local_mesh("cpu") is None
