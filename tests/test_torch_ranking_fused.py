"""The port's no-matrix ranking (fused ranks) against the JAX package's.

Same numpy inputs to both packages.  The JAX fused ranks reach their
Pallas kernel in interpret mode (as tests/test_metrics_losses.py runs
it); the port's run the plain version (CPU tensors).  Tolerances: ranks
within 1e-5 at the small shapes, where no two similarities are near a
tie; at 10k candidates the GT similarity is computed directly on the
fused path and read from the product on the matrix path, so fp32
rounding of near-ties may move a rank by 1 for a few queries (at most 1,
on < 1e-3 of them, the JAX package's own rule); exact-arithmetic inputs
and the metric dicts are held to equality.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mmt_tpu.models.cenet import CENet as FlaxCENet
from mmt_tpu.ops import ffn as flax_ffn
from mmt_tpu.ops import ranking as jax_ranking
from mmt_tpu.ops import similarity as flax_similarity
from mmt_tpu.train import metrics as jax_metrics
from mmt_tpu_torch import bench, convert, evaluate
from mmt_tpu_torch.flagship import batch_to_torch
from mmt_tpu_torch.models.cenet import CENet
from mmt_tpu_torch.ops import ranking, similarity
from mmt_tpu_torch.train import metrics
from tests.conftest import make_batch


def _embeddings(rng, caps, nv, m, d):
  q = nv * caps
  return (rng.randn(q, m, d).astype(np.float32),
          rng.randn(nv, m, d).astype(np.float32),
          np.abs(rng.rand(q, m)).astype(np.float32),
          np.abs(rng.rand(nv, m)).astype(np.float32))


def _torch(*arrays):
  return [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays]


def _assert_rank_rule(got, want):
  """Same inf positions; finite ranks within 1, on < 1e-3 of queries."""
  got, want = np.asarray(got), np.asarray(want)
  np.testing.assert_array_equal(np.isinf(got), np.isinf(want))
  finite = np.isfinite(want)
  diff = np.abs(got[finite] - want[finite])
  assert diff.max() <= 1.0, f"rank disagreement > 1: {diff.max()}"
  assert (diff > 0).mean() < 1e-3, f"{(diff > 0).sum()} queries differ"


@pytest.mark.parametrize("case", ["plain", "zero_weight_rows",
                                  "vid_valid_padding", "masked_slots"])
def test_fused_ranks_match_jax_kernel(case):
  rng = np.random.RandomState(0)
  caps, nv, m, d = 2, 12, 3, 16
  text, vid, tw, vw = _embeddings(rng, caps, nv, m, d)
  masks = np.ones((nv, caps), np.float32)
  vid_valid = None
  if case == "zero_weight_rows":    # the denominator's 1e-5 guard
    tw[3] = 0.0
    vw[5] = 0.0
  elif case == "vid_valid_padding":  # padding rows, as a mesh pads them
    vid[-2:], vw[-2:], text[-4:], tw[-4:] = 0.0, 0.0, 0.0, 0.0
    masks[-2:] = 0.0
    vid_valid = np.array([1.0] * (nv - 2) + [0.0] * 2, np.float32)
  elif case == "masked_slots":
    masks[3, 1] = 0.0
    masks[5, :] = 0.0              # every slot masked: rank inf

  want_t2v = np.asarray(jax_ranking.fused_t2v_ranks(
      *map(jnp.asarray, (text, vid, tw, vw)),
      vid_valid=None if vid_valid is None else jnp.asarray(vid_valid),
      interpret=True))
  want_v2t = np.asarray(jax_ranking.fused_v2t_ranks(
      *map(jnp.asarray, (text, vid, tw, vw, masks)), interpret=True))
  t, v, twt, vwt, mt = _torch(text, vid, tw, vw, masks)
  got_t2v = ranking.fused_t2v_ranks(
      t, v, twt, vwt,
      None if vid_valid is None else torch.from_numpy(vid_valid)).numpy()
  got_v2t = ranking.fused_v2t_ranks(t, v, twt, vwt, mt).numpy()

  np.testing.assert_allclose(got_t2v, want_t2v, atol=1e-5)
  np.testing.assert_array_equal(np.isinf(got_v2t), np.isinf(want_v2t))
  np.testing.assert_allclose(got_v2t, want_v2t, atol=1e-5)
  if case == "masked_slots":
    assert np.isinf(got_v2t[5]) and np.isinf(want_v2t[5])
  if case == "vid_valid_padding":
    # A dead candidate never outranks a live one.
    np.testing.assert_array_less(got_t2v[:-4], nv - 2)


def test_fused_ranks_exact_ties():
  """Values in {0, +-0.5, +-1} and unit weights make every partial sum
  exact in fp32, so the direct GT value equals the product's and every
  path gives the same ranks; duplicated rows make real ties."""
  rng = np.random.RandomState(1)
  caps, nv, m, d = 2, 12, 3, 16
  q = nv * caps
  text = (rng.randint(-2, 3, (q, m, d)) / 2).astype(np.float32)
  vid = (rng.randint(-2, 3, (nv, m, d)) / 2).astype(np.float32)
  vid[7] = vid[2]            # a duplicate of video 2: a tie for its captions
  vid[9] = vid[0]
  text[11] = text[4]         # a duplicate caption: a tie in v2t
  tw, vw = np.ones((q, m), np.float32), np.ones((nv, m), np.float32)
  masks = np.ones((nv, caps), np.float32)
  t, v, twt, vwt, mt = _torch(text, vid, tw, vw, masks)

  sims = similarity.moe_similarity(t, v, twt, vwt, merge="indep",
                                   num_caps=caps)
  got_t2v = ranking.fused_t2v_ranks(t, v, twt, vwt)
  got_v2t = ranking.fused_v2t_ranks(t, v, twt, vwt, mt)
  torch.testing.assert_close(got_t2v, ranking.t2v_ranks(sims), rtol=0,
                             atol=0)
  torch.testing.assert_close(got_v2t, ranking.v2t_ranks(sims, mt), rtol=0,
                             atol=0)
  np.testing.assert_array_equal(got_t2v.numpy(), np.asarray(
      jax_ranking.fused_t2v_ranks(*map(jnp.asarray, (text, vid, tw, vw)),
                                  interpret=True)))
  np.testing.assert_array_equal(got_v2t.numpy(), np.asarray(
      jax_ranking.fused_v2t_ranks(
          *map(jnp.asarray, (text, vid, tw, vw, masks)), interpret=True)))

  qs, qw = ranking._scaled_flat(t, twt)
  vs, vw_ = ranking._scaled_flat(v, vwt)
  gtcol = torch.arange(q) // caps
  gt = ranking._gt_sims(qs, vs, qw, vw_, gtcol)
  _, tied = ranking.fused_counts_plain(qs, vs, qw, vw_, gt, gtcol,
                                       torch.zeros(nv))
  assert tied[4] == 1 and tied[14] == 1      # captions of videos 2 and 7


@pytest.mark.parametrize("orientation", ["t2v", "v2t"])
def test_fused_ranks_10k_match_matrix_and_jax(orientation):
  rng = np.random.RandomState(0)
  caps, nv = (1, 10_000) if orientation == "t2v" else (2, 5_000)
  text, vid, tw, vw = _embeddings(rng, caps, nv, 2, 8)
  masks = (rng.rand(nv, caps) > 0.1).astype(np.float32)
  masks[0] = 0.0             # every caption masked: rank inf
  t, v, twt, vwt, mt = _torch(text, vid, tw, vw, masks)
  sims = similarity.moe_similarity(t, v, twt, vwt, merge="indep",
                                   num_caps=caps)
  jargs = tuple(map(jnp.asarray, (text, vid, tw, vw)))
  if orientation == "t2v":
    got = ranking.t2v_ranks_from_embeddings(t, v, twt, vwt)
    matrix = ranking.t2v_ranks(sims)
    jax_got = jax_ranking.t2v_ranks_from_embeddings(*jargs)
  else:
    got = ranking.v2t_ranks_from_embeddings(t, v, twt, vwt, mt)
    matrix = ranking.v2t_ranks(sims, mt)
    jax_got = jax_ranking.v2t_ranks_from_embeddings(*jargs,
                                                    jnp.asarray(masks))
    assert np.isinf(got[0].item())
  _assert_rank_rule(got.numpy(), matrix.numpy())
  _assert_rank_rule(got.numpy(), np.asarray(jax_got))


def test_fused_retrieval_metrics_match_jax():
  rng = np.random.RandomState(3)
  caps, nv = 2, 20
  text, vid, tw, vw = _embeddings(rng, caps, nv, 2, 8)
  masks = (rng.rand(nv, caps) > 0.2).astype(np.float32)
  want = jax_metrics.fused_retrieval_metrics(text, vid, tw, vw, masks)
  got = metrics.fused_retrieval_metrics(text, vid, tw, vw, masks,
                                        device="cpu")
  assert got == want
  # Tensors are taken as they are.
  assert metrics.fused_retrieval_metrics(*_torch(text, vid, tw, vw, masks),
                                         device="cpu") == want


def _salted_numpy_chunks(batch, passes, vocab):
  """bench.salted_passes over one numpy chunk, for the JAX side."""
  out = []
  for p in range(passes):
    salted = dict(batch)
    salted["token_ids"] = batch["token_ids"].copy()
    salted["token_ids"][..., 0] = (batch["token_ids"][..., 0] + p) % vocab
    salted["features"] = {m: f + np.float32(0.001 * (p + 1))
                          for m, f in batch["features"].items()}
    out.append(salted)
  return out


def test_fused_eval_slice_matches_flax(tiny_arch):
  """The slice end to end: a tiny flax CENet with the flagship switches
  (Pallas FFN and similarity in interpret mode) and the JAX fused ranks
  against the port's retrieval_eval(fused=True) on the same weights and
  the same two salted chunks; then the port's fused eval against its
  matrix eval."""
  batch = make_batch(tiny_arch["expert_dims"], b=3, k=2, t=7, l=5)
  batch["query_masks"][1, 1] = 0.0
  vocab = tiny_arch["text_bert_geometry"]["vocab_size"]
  chunks = _salted_numpy_chunks(batch, 2, vocab)

  model = FlaxCENet(**tiny_arch)
  variables = model.init(
      {"params": jax.random.PRNGKey(0), "dropout": jax.random.PRNGKey(1)},
      batch, train=False)
  rng = np.random.RandomState(5)
  stats = jax.tree_util.tree_map(np.asarray, variables["batch_stats"])
  for mod in stats:
    bn = stats[mod]["cg"]["batch_norm"]["bn"]
    bn["mean"] = (rng.randn(*bn["mean"].shape) * 0.1).astype(np.float32)
    bn["var"] = (np.abs(rng.randn(*bn["var"].shape)) + 0.5).astype(
        np.float32)
  variables = {"params": variables["params"], "batch_stats": stats}
  flax_ffn.use_pallas(True, interpret=True)
  flax_similarity.use_pallas(True, interpret=True)
  try:
    outs = [model.apply(variables, c, train=False) for c in chunks]
  finally:
    flax_ffn.use_pallas(False)
    flax_similarity.use_pallas(False)
  cat = {k: jnp.concatenate([o[k] for o in outs], 0) for k in outs[0]}
  b, k, m, d = cat["text_embds"].shape
  te = cat["text_embds"].reshape(b * k, m, d)
  tw = cat["text_weights"].reshape(b * k, m)
  masks = np.concatenate([c["query_masks"] for c in chunks], 0)
  cols = np.asarray(jax_ranking.fused_t2v_ranks(
      te, cat["vid_embds"], tw, cat["vid_weights"], interpret=True))
  keep = masks.reshape(-1).astype(bool)
  ranks = np.asarray(jax_ranking.fused_v2t_ranks(
      te, cat["vid_embds"], tw, cat["vid_weights"], jnp.asarray(masks),
      interpret=True))
  want = {"t2v_metrics": jax_metrics.cols2metrics(cols[keep],
                                                  int(keep.sum())),
          "v2t_metrics": jax_metrics.cols2metrics(ranks[:b], b)}

  port = CENet(**tiny_arch, device="cpu").eval()
  port.load_state_dict(convert.state_dict_from_flax(
      jax.tree_util.tree_map(np.asarray, variables["params"]),
      variables["batch_stats"]), strict=True)
  staged = [batch_to_torch(batch, "cpu")]
  got = evaluate.retrieval_eval(
      port, bench.salted_passes(staged, 6, vocab), fused=True)
  assert "sims" not in got
  assert got == want

  # The port's fused ranks against its matrix ranks on the same
  # embeddings.  They differ only in the GT value (computed directly on
  # the fused path, read from the product on the matrix path), and the
  # salted copies of a video are near-ties (their similarities differ by
  # ~1e-6), so a rank may move by the candidates that lie between the two
  # GT values, and by nothing else.
  emb = evaluate.embed_corpus(port, bench.salted_passes(staged, 6, vocab))
  _assert_only_gt_rounding_differs(emb["text_embds"], emb["vid_embds"],
                                   emb["text_weights"], emb["vid_weights"],
                                   emb["query_masks"])


def _between(a, g_fused, gtcol):
  """Per row of a [rows, cands] similarity matrix: the candidates other
  than the GT column whose similarity lies between the fused path's GT
  value and the matrix's."""
  g_matrix = a.gather(1, gtcol[:, None])[:, 0]
  lo = torch.minimum(g_fused, g_matrix)[:, None]
  hi = torch.maximum(g_fused, g_matrix)[:, None]
  return ((a >= lo) & (a <= hi)).sum(1) - 1


def _assert_only_gt_rounding_differs(te, ve, tw, vw, masks):
  nv, caps = masks.shape
  sims = similarity.moe_similarity(te, ve, tw, vw, merge="indep",
                                   num_caps=caps)
  ts, tws = ranking._scaled_flat(te, tw)
  vs, vws = ranking._scaled_flat(ve, vw)
  gtcol = torch.arange(nv * caps) // caps
  bound = _between(sims, ranking._gt_sims(ts, vs, tws, vws, gtcol), gtcol)
  diff = (ranking.fused_t2v_ranks(te, ve, tw, vw)
          - ranking.t2v_ranks(sims)).abs()
  assert (diff <= bound).all(), (diff, bound)

  live = masks.reshape(-1).bool()
  a = torch.where(live[None, :], sims.T, -ranking.MISSING_VAL)
  bound = torch.zeros(nv, dtype=torch.long)
  for j in range(caps):
    gtcol = torch.arange(nv) * caps + j
    g = ranking._gt_sims(vs, ts, vws, tws, gtcol)
    bound = torch.maximum(bound, _between(a, g, gtcol))
  got = ranking.fused_v2t_ranks(te, ve, tw, vw, masks)
  want = ranking.v2t_ranks(sims, masks)
  torch.testing.assert_close(torch.isinf(got), torch.isinf(want))
  finite = torch.isfinite(want)
  assert ((got - want).abs()[finite] <= bound[finite]).all()


def test_fused_counts_cuda_takes_only_cuda_tensors():
  rng = np.random.RandomState(0)
  text, vid, tw, vw = _torch(*_embeddings(rng, 1, 6, 2, 4))
  before = ranking.fused_counts_cuda.launches
  ranks = ranking.fused_t2v_ranks(text, vid, tw, vw)
  assert ranks.shape == (6,)
  assert ranking.fused_counts_cuda.launches == before
  qs, qw = ranking._scaled_flat(text, tw)
  vs, vw_ = ranking._scaled_flat(vid, vw)
  for tile in (None, 0, 1, 99):   # no tile makes it take the plain version
    with pytest.raises(ValueError, match="CUDA"):
      ranking.fused_counts_cuda(qs, vs, qw, vw_, torch.zeros(6),
                                torch.arange(6), torch.zeros(6), tile=tile)
  assert ranking.fused_counts_cuda.launches == before


@pytest.mark.parametrize("orientation", ["t2v", "v2t"])
def test_fused_counts_equal_counts_of_the_sims_matrix(orientation):
  """The counts the fused path returns are the counts of the similarity
  matrix itself (sim_plain + colbias, > and == against the same gt, the
  GT column left out), on exact-arithmetic inputs with ties, masked
  caption slots and padding videos; and they are the JAX _rank_kernel's
  (interpret mode).  On the card the same check holds bitwise between the
  two CUDA kernels, which share one tile code."""
  rng = np.random.RandomState(2)
  caps, nv, m, d, pad = 2, 14, 3, 16, 2
  q = nv * caps
  text = (rng.randint(-2, 3, (q, m, d)) / 2).astype(np.float32)
  vid = (rng.randint(-2, 3, (nv, m, d)) / 2).astype(np.float32)
  vid[7] = vid[2]                   # ties for the captions of video 2
  text[11] = text[4]                # a duplicate caption: a tie in v2t
  tw, vw = np.ones((q, m), np.float32), np.ones((nv, m), np.float32)
  masks = np.ones((nv, caps), np.float32)
  masks[3, 1] = 0.0
  vid[-pad:], vw[-pad:], masks[-pad:] = 0.0, 0.0, 0.0   # padding videos
  text[-pad * caps:], tw[-pad * caps:] = 0.0, 0.0
  t, v, twt, vwt = _torch(text, vid, tw, vw)
  ts, tws = ranking._scaled_flat(t, twt)
  vs, vws = ranking._scaled_flat(v, vwt)
  if orientation == "t2v":
    args = [ts, vs, tws, vws]
    gtcol = torch.arange(q) // caps
    colbias = torch.zeros(nv)
    colbias[-pad:] = -ranking.MISSING_VAL
  else:
    args = [vs, ts, vws, tws]
    gtcol = torch.arange(nv) * caps + 1
    colbias = torch.where(torch.from_numpy(masks).reshape(-1).bool(), 0.0,
                          -ranking.MISSING_VAL)
  gt = ranking._gt_sims(*args, gtcol)
  args += [gt, gtcol, colbias]

  closer, tied = ranking.fused_counts_plain(*args)
  sims = similarity.sim_plain(*args[:4]) + colbias[None, :]
  valid = torch.arange(sims.shape[1])[None, :] != gtcol[:, None]
  torch.testing.assert_close(
      closer, (valid & (sims > gt[:, None])).sum(1).float(), rtol=0, atol=0)
  torch.testing.assert_close(
      tied, (valid & (sims == gt[:, None])).sum(1).float(), rtol=0, atol=0)
  assert tied.sum() > 0
  want = jax_ranking._fused_counts(
      *(jnp.asarray(a.numpy()) for a in args), interpret=True)
  np.testing.assert_array_equal(closer.numpy(), np.asarray(want[0]))
  np.testing.assert_array_equal(tied.numpy(), np.asarray(want[1]))


def test_bench_streaming_eval_runs_tiny_on_cpu(monkeypatch, capsys):
  run = bench.build_streaming_eval("cpu", tiny=True, videos=4, chunk=2)
  res = bench.streaming_eval(run, 8, staged_videos=4)
  # bench.py:226-227's keys.
  assert set(res) == {"n_videos", "wall_s", "videos_per_sec_per_chip"}
  assert res["n_videos"] == 8 and res["wall_s"] > 0

  for name, value in (("BENCH_VIDEOS", "4"), ("BENCH_BATCH", "2"),
                      ("BENCH_REPS", "1"), ("BENCH_TRAIN", "0"),
                      ("BENCH_LARGE", "8")):
    monkeypatch.setenv(name, value)
  bench.main(["--device", "cpu", "--tiny"])
  got = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
  # bench.py's keys, less the TPU setup's own, plus the port's.
  assert set(got) == {"metric", "value", "unit", "latency_s_1kx1k",
                      "backend", "dtype", "kernels", "kernel_families",
                      "card", "streaming_eval"}
  assert got["backend"] == "cpu" and got["kernels"] is False
  assert set(got["streaming_eval"]) == set(res)
