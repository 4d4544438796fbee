"""The port's serving entry point (mmt_tpu_torch.serving, .serve) on the
CPU, against the JAX package's (mmt_tpu/serving.py, scripts/serve.py).

One tiny model is trained by the JAX CLI on the synthetic corpus and
tiny config of tests/test_torch_trainer.py, then carried over to the port
twice: through ``convert.state_dict_from_flax`` and as a ``.pth`` written
by scripts/export_checkpoint.py.  Both packages then build an index from
the same eval loader and answer the same queries.  Tolerances: index
embeddings and weights 1e-5 (fp32); exact scores 1e-5, int8 scores 1e-4;
ids equal except among scores tied within that tolerance (``torch.topk``
and ``lax.top_k`` may order ties differently); int8 codes and scales
bitwise; the int8 similarity 1e-6 relative.
"""

import contextlib
import importlib.util
import io
import json
import os
import pathlib
import runpy
import subprocess
import sys
import threading
import urllib.error
import urllib.parse
import urllib.request

import numpy as np
import pytest
import torch

from mmt_tpu_torch import convert, serve, serving
from mmt_tpu_torch.data import synthetic

REPO = pathlib.Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO / "tests"))
from test_train_e2e import make_config  # noqa: E402

EXACT_TOL, INT8_TOL, EMBD_TOL = 1e-5, 1e-4, 1e-5
QUERIES = ["a video of cooking", "a video of soccer", "a video of rain"]


def _load_by_path(name, path):
  spec = importlib.util.spec_from_file_location(name, path)
  module = importlib.util.module_from_spec(spec)
  spec.loader.exec_module(module)
  return module


@pytest.fixture(scope="module")
def world(tmp_path_factory):
  """The JAX-trained tiny model, its msgpack and exported .pth, the JAX
  package's model/variables/loader/tokenizer and the port's model (from
  the .pth) with its loader."""
  import jax
  import train as jax_cli
  from mmt_tpu.train import checkpoint as jax_ckpt

  root = tmp_path_factory.mktemp("torch_serving")
  data_dir = synthetic.generate(root, num_videos=14, num_test=6,
                                experts={"rgb": 2048, "s3d": 1024},
                                captions_per_video=3)
  prev_vocab = os.environ.get("MMT_TPU_BERT_VOCAB")
  os.environ["MMT_TPU_BERT_VOCAB"] = str(root / "vocab.txt")
  cfg_path = root / "cfg.json"
  cfg_path.write_text(json.dumps(make_config(root, data_dir,
                                             root / "exps" / "jax")))
  jax_trainer = jax_cli.main(["--config", str(cfg_path)])
  msgpack = root / "exps" / "jax" / "trained_model.msgpack"
  pth = root / "exported.pth"
  argv, path = sys.argv, list(sys.path)
  sys.argv = ["export_checkpoint.py", "--checkpoint", str(msgpack),
              "--out", str(pth)]
  sys.path.insert(0, str(REPO / "scripts"))
  try:
    runpy.run_path(str(REPO / "scripts" / "export_checkpoint.py"),
                   run_name="__main__")
  finally:
    sys.argv, sys.path[:] = argv, path
  raw = jax_ckpt.load_checkpoint_raw(msgpack)
  to_np = lambda tree: jax.tree_util.tree_map(np.asarray, tree)
  variables = {"params": to_np(raw["params"]),
               "batch_stats": to_np(raw["batch_stats"])}
  model, tokenizer, entry, max_words = serve.load_model_and_loader(
      cfg_path, pth, "cpu")
  jax_entry = jax_trainer.data_loaders["final_eval_sets"][0]
  yield dict(root=root, cfg_path=cfg_path, msgpack=msgpack, pth=pth,
             variables=variables, jax_model=jax_trainer.model,
             jax_tokenizer=jax_trainer.tokenizer, jax_entry=jax_entry,
             model=model, tokenizer=tokenizer, entry=entry,
             max_words=max_words)
  if prev_vocab is None:
    os.environ.pop("MMT_TPU_BERT_VOCAB", None)
  else:
    os.environ["MMT_TPU_BERT_VOCAB"] = prev_vocab


@pytest.fixture(scope="module")
def indexes(world):
  """The JAX package's and the port's index of the eval set."""
  from mmt_tpu import serving as jax_serving
  jax_index = jax_serving.RetrievalIndex.build(
      world["jax_model"], world["variables"], world["jax_entry"]["loader"],
      dataset=world["jax_entry"]["dataset"].datasets[0])
  index = serving.RetrievalIndex.build(
      world["model"], world["entry"]["loader"],
      dataset=world["entry"]["dataset"].datasets[0])
  return jax_index, index


def copy_index(index, keep=None):
  keep = range(len(index)) if keep is None else keep
  keep = list(keep)
  return serving.RetrievalIndex(index.vid_embds[keep].copy(),
                                index.vid_weights[keep].copy(),
                                [index.video_ids[i] for i in keep],
                                [index.paths[i] for i in keep])


def engine(world, index, **kw):
  return serving.RetrievalEngine(world["model"], world["tokenizer"], index,
                                 max_text_words=world["max_words"], **kw)


def jax_engine(world, index, **kw):
  from mmt_tpu import serving as jax_serving
  return jax_serving.RetrievalEngine(
      world["jax_model"], world["variables"], world["jax_tokenizer"], index,
      max_text_words=world["max_words"], **kw)


def assert_hits_match(want, got, tol):
  """Scores within ``tol``; ids equal, except where the two scores at a
  rank lie within ``tol`` of another score of the query (a tie, which the
  two top-ks may order differently)."""
  assert len(want) == len(got)
  for w_hits, g_hits in zip(want, got):
    assert len(w_hits) == len(g_hits)
    w_scores = np.array([h["score"] for h in w_hits])
    np.testing.assert_allclose([h["score"] for h in g_hits], w_scores,
                               rtol=0, atol=tol)
    for r, (w, g) in enumerate(zip(w_hits, g_hits)):
      if w["video_id"] != g["video_id"]:
        others = np.delete(w_scores, r)
        assert np.abs(others - w["score"]).min() <= 2 * tol, (r, w, g)
      assert g["rank"] == r


def test_two_carry_overs_agree(world):
  """convert.state_dict_from_flax and the exported .pth (strictly loaded)
  give the port the same weights."""
  sd = convert.state_dict_from_flax(world["variables"]["params"],
                                    world["variables"]["batch_stats"])
  got = world["model"].state_dict()
  assert set(sd) == set(got)
  for name, t in sd.items():
    assert torch.equal(got[name], t.to(got[name].dtype)), name


def test_quantize_rows_int8_matches_jax():
  from mmt_tpu import serving as jax_serving
  rng = np.random.RandomState(0)
  flat = rng.randn(40, 3584).astype(np.float32)
  flat[[3, 17]] = 0.0
  flat[5] *= 1e-3
  got = serving._quantize_rows_int8(flat)
  want = jax_serving._quantize_rows_int8(flat)
  for g, w in zip(got, want):
    assert g.dtype == w.dtype and np.array_equal(g, w)
  assert (got[0][[3, 17]] == 0).all() and (got[1][[3, 17]] == 1).all()


def test_int8_moe_similarity_matches_jax():
  import jax.numpy as jnp
  from mmt_tpu import serving as jax_serving
  rng = np.random.RandomState(1)
  q, v, m, d = 9, 33, 5, 64
  t = rng.randn(q, m, d).astype(np.float32)
  vid = rng.randn(v, m, d).astype(np.float32)
  tw, vw = rng.rand(q, m).astype(np.float32), rng.rand(v, m).astype(np.float32)
  tw[2] = 0.0
  vw[4] = 0.0
  q8, scale = serving._quantize_rows_int8((vid * vw[:, :, None])
                                          .reshape(v, m * d))
  want = np.asarray(jax_serving._int8_moe_similarity(
      jnp.asarray(t), jnp.asarray(tw), jnp.asarray(q8), jnp.asarray(scale),
      jnp.asarray(vw)))
  got = serving._int8_moe_similarity(
      torch.from_numpy(t), torch.from_numpy(tw), torch.from_numpy(q8),
      torch.from_numpy(scale), torch.from_numpy(vw)).numpy()
  np.testing.assert_allclose(got, want, rtol=1e-6, atol=0)


def test_index_build_matches_jax(indexes):
  jax_index, index = indexes
  assert len(index) == 6 and index.vid_embds.shape[1:] == (2, 48)
  np.testing.assert_allclose(index.vid_embds, jax_index.vid_embds,
                             rtol=0, atol=EMBD_TOL)
  np.testing.assert_allclose(index.vid_weights, jax_index.vid_weights,
                             rtol=0, atol=EMBD_TOL)
  assert index.video_ids == jax_index.video_ids
  assert index.paths == jax_index.paths


@pytest.mark.parametrize("quantize,tol", [(None, EXACT_TOL),
                                          ("int8", INT8_TOL)])
def test_search_matches_jax(world, indexes, quantize, tol):
  jax_index, index = indexes
  want = jax_engine(world, jax_index, quantize=quantize).search(QUERIES, 4)
  got = engine(world, index, quantize=quantize).search(QUERIES, 4)
  assert_hits_match(want, got, tol)


def test_search_edge_cases(world):
  """topk 0 (no results), topk above 10 (here 13 of 16, equal to the JAX
  engine's and a prefix of the full ranking), topk above the index size
  (capped), on a seeded index of 16 rows, exact and int8."""
  from mmt_tpu import serving as jax_serving
  rng = np.random.RandomState(7)
  embds = rng.randn(16, 2, 48).astype(np.float32)
  embds /= np.linalg.norm(embds, axis=-1, keepdims=True)
  weights = rng.rand(16, 2).astype(np.float32)
  weights /= weights.sum(-1, keepdims=True)
  ids = [f"v{i}" for i in range(16)]
  for quantize, tol in ((None, EXACT_TOL), ("int8", INT8_TOL)):
    eng = engine(world, serving.RetrievalIndex(embds, weights, ids,
                                               [""] * 16), quantize=quantize)
    assert eng.search(QUERIES[:2], topk=0) == [[], []]
    assert eng.search(QUERIES[:1], topk=-3) == [[]]
    full = eng.search(QUERIES, topk=16)
    got13 = eng.search(QUERIES, topk=13)
    assert eng.search(QUERIES, topk=99) == full
    for f_hits, g_hits in zip(full, got13):
      assert len(f_hits) == 16 and len(g_hits) == 13
      assert g_hits == f_hits[:13]
    want13 = jax_engine(world, jax_serving.RetrievalIndex(
        embds, weights, ids, [""] * 16), quantize=quantize).search(QUERIES,
                                                                   13)
    assert_hits_match(want13, got13, tol)


def test_index_save_load_round_trip(indexes, tmp_path):
  """.npz round trip (read back with allow_pickle=False, written to the
  path as given), the newline refusal and the corrupt-index check."""
  index = indexes[1]
  path = tmp_path / "index.bin"
  index.save(path)
  assert path.exists() and not (tmp_path / "index.bin.npz").exists()
  back = serving.RetrievalIndex.load(path)
  assert np.array_equal(back.vid_embds, index.vid_embds)
  assert np.array_equal(back.vid_weights, index.vid_weights)
  assert back.video_ids == index.video_ids and back.paths == index.paths
  with np.load(path, allow_pickle=False) as raw:
    assert sorted(raw.files) == ["paths", "vid_embds", "vid_weights",
                                 "video_ids"]

  for field in ("video_ids", "paths"):
    bad = copy_index(index)
    getattr(bad, field)[1] = "two\nlines"
    with pytest.raises(ValueError, match="newline"):
      bad.save(tmp_path / "bad.npz")
  with open(tmp_path / "corrupt.npz", "wb") as f:
    np.savez(f, vid_embds=index.vid_embds, vid_weights=index.vid_weights,
             video_ids=np.array("\n".join(index.video_ids[:-1])),
             paths=np.array("\n".join(index.paths)))
  with pytest.raises(ValueError, match="corrupt index"):
    serving.RetrievalIndex.load(tmp_path / "corrupt.npz")


def test_emptied_index_round_trip_and_regrow(world, indexes, tmp_path):
  index = indexes[1]
  drained = copy_index(index)
  drained.remove(list(drained.video_ids))
  assert len(drained) == 0 and drained.video_ids == []
  drained.save(tmp_path / "empty.npz")
  reloaded = serving.RetrievalIndex.load(tmp_path / "empty.npz")
  assert len(reloaded) == 0 and reloaded.video_ids == [] == reloaded.paths
  for quantize in (None, "int8"):
    eng = engine(world, reloaded, quantize=quantize)
    assert eng.search(["anything"], topk=3) == [[]]
  eng = engine(world, reloaded)
  reloaded.extend(index)
  assert reloaded.video_ids == index.video_ids
  eng.refresh()
  assert (eng.search(QUERIES[:1], topk=3)
          == engine(world, index).search(QUERIES[:1], topk=3))


def test_extend_remove_and_refresh(world, indexes):
  """extend/remove mutate the corpus without re-embedding; refresh()
  re-stages a live engine (exact and int8), whose results then equal a
  fresh engine's; bad extends and removals refuse before mutating."""
  index = indexes[1]
  old, new = range(4), range(4, 6)
  grown = copy_index(index, old)
  live = engine(world, grown)
  before = live.search(QUERIES, topk=3)
  assert all(h["video_id"] in grown.video_ids for r in before for h in r)
  grown.extend(copy_index(index, new))
  live.refresh()
  assert live.search(QUERIES, topk=4) == engine(world, grown).search(
      QUERIES, topk=4)
  assert np.array_equal(grown.vid_embds, index.vid_embds)

  live.refresh(grown.remove(index.video_ids[4:]))
  after = live.search(QUERIES, topk=6)
  for b_hits, a_hits in zip(before, after):
    assert len(a_hits) == 4
    assert a_hits[:3] == b_hits

  q8_live = engine(world, grown, quantize="int8")
  grown.extend(copy_index(index, new))
  q8_live.refresh()
  assert (q8_live.search(QUERIES, topk=4)
          == engine(world, grown, quantize="int8").search(QUERIES, topk=4))

  with pytest.raises(ValueError, match="duplicate"):
    grown.extend(copy_index(index, [0]))
  with pytest.raises(ValueError, match="geometry"):
    grown.extend(serving.RetrievalIndex(np.zeros((1, 3, 7), np.float32),
                                        np.zeros((1, 3), np.float32),
                                        ["zz"], ["zz"]))
  with pytest.raises(KeyError):
    grown.remove(["not-there"])
  assert len(grown) == 6


def test_failed_refresh_keeps_the_staged_snapshot(world, indexes,
                                                  monkeypatch):
  """A refresh whose staging raises (out of device memory) leaves the
  engine serving its previous tensors with their own ids."""
  index = indexes[1]
  eng = engine(world, copy_index(index, range(3)))
  before = eng.search(QUERIES, topk=3)

  def fail(*args, **kwargs):
    raise RuntimeError("out of memory")

  monkeypatch.setattr(serving, "stage_index", fail)
  with pytest.raises(RuntimeError, match="out of memory"):
    eng.refresh(copy_index(index))
  assert eng.num_videos == 3 and eng.search(QUERIES, topk=3) == before


def test_engine_refuses_what_it_does_not_serve(world, indexes):
  """An unknown quantization, and a mesh= that is not a sequence of
  devices (the engine shards over local devices, one process)."""
  with pytest.raises(ValueError):
    engine(world, indexes[1], quantize="fp8")
  for mesh in (object(), "cpu", [], [object()]):
    with pytest.raises(TypeError, match="sequence of torch devices"):
      engine(world, indexes[1], mesh=mesh)


def test_search_consistent_across_inplace_mutation(world, indexes):
  """Between an in-place mutation and refresh() search serves the staged
  snapshot; searches racing refresh() always map to a consistent one."""
  full = indexes[1]
  idx = copy_index(full)
  eng = engine(world, idx)
  before = eng.search(QUERIES[:2], topk=len(full))
  idx.remove(full.video_ids[1:])
  assert eng.search(QUERIES[:2], topk=len(full)) == before
  assert eng.num_videos == len(full)
  eng.refresh()
  assert eng.num_videos == 1
  assert all(len(h) == 1 and h[0]["video_id"] == full.video_ids[0]
             for h in eng.search(QUERIES[:2], topk=len(full)))

  valid, errors = set(full.video_ids), []

  def reader():
    try:
      for _ in range(12):
        for hits in eng.search(QUERIES[:2], topk=6):
          assert all(h["video_id"] in valid for h in hits)
    except Exception as exc:  # pragma: no cover - failure path
      errors.append(exc)

  thread = threading.Thread(target=reader)
  thread.start()
  for i in range(8):
    eng.refresh(copy_index(full, [0, 1, 2] if i % 2 == 0 else range(6)))
  thread.join(timeout=120)
  assert not thread.is_alive() and not errors


def _get(url):
  with urllib.request.urlopen(url, timeout=60) as resp:
    return json.loads(resp.read())


def _post(url, body):
  req = urllib.request.Request(url, data=body,
                               headers={"Content-Type": "application/json"})
  with urllib.request.urlopen(req, timeout=60) as resp:
    return json.loads(resp.read())


def test_http_api_and_statz(world, indexes):
  """/healthz, GET and POST /search (the engine's hits), the topk clamp
  and the no-results probe, 400s (no query, bad topk, bad body, too many
  queries), 404s, and /statz's counters and latency percentiles."""
  eng = engine(world, indexes[1])
  server = serving.serve_http(eng, port=0, block=False)
  base = f"http://127.0.0.1:{server.server_address[1]}"
  try:
    assert _get(f"{base}/healthz") == {"ok": True, "videos": 6}
    empty = _get(f"{base}/statz")
    assert empty["videos"] == 6 and empty["requests"] == 0
    assert "search_latency_ms" not in empty
    queries = QUERIES[:2]
    want = eng.search(queries, topk=3)
    q = "&".join("q=" + urllib.parse.quote(s) for s in queries)
    assert _get(f"{base}/search?{q}&topk=3")["results"] == want
    body = json.dumps({"queries": queries, "topk": 3}).encode()
    assert _post(f"{base}/search", body)["results"] == want
    assert len(_get(f"{base}/search?q=cooking&topk=99")["results"][0]) == 6
    for k in (0, -3):
      assert _get(f"{base}/search?q=cooking&topk={k}")["results"] == [[]]
    stats = _get(f"{base}/statz")
    assert stats["requests"] == 5 and stats["queries"] == 7
    assert stats["errors"] == 0
    lat = stats["search_latency_ms"]
    assert lat["count"] == 5 and 0 < lat["p50"] <= lat["p99"] <= lat["max"]

    too_many = json.dumps({"queries": ["x"] * 257}).encode()
    for url, body, code in (
        (f"{base}/search", None, 400), (f"{base}/search?q=x&topk=abc", None,
                                        400),
        (f"{base}/search?q=%20", None, 400), (f"{base}/nope", None, 404),
        (f"{base}/search", b"not json", 400),
        (f"{base}/search", b'{"queries": "x"}', 400),
        (f"{base}/search", too_many, 400), (f"{base}/nope", b"{}", 404)):
      with pytest.raises(urllib.error.HTTPError) as err:
        _get(url) if body is None else _post(url, body)
      assert err.value.code == code, url
    assert _get(f"{base}/statz")["requests"] == 5
  finally:
    server.shutdown()
    server.server_close()


def test_int8_quality_pinned_and_equal_to_jax():
  """The pinned int8 rule of tests/test_serving.py on the same planted
  corpus, through the port's staged tensors (mmt_tpu_torch.int8_quality,
  which chip_smoke.py's phase 12 runs at 10,000 videos on the card); the
  report equals scripts/int8_quality.py's."""
  from mmt_tpu_torch import int8_quality as port
  sys.path.insert(0, str(REPO / "scripts"))
  import int8_quality
  corpus = port.make_corpus(512, 64, seed=0)
  for got, want in zip(corpus, int8_quality.make_corpus(512, 64, seed=0)):
    assert np.array_equal(got, want)
  rep = port.quality_report(*corpus, device="cpu")
  assert port.faults(rep) == [], rep
  want = int8_quality.quality_report(*corpus, topk=10)
  for key in want:
    if key.startswith(("R", "overlap", "top1")):
      assert rep[key] == want[key], key
    else:
      assert abs(rep[key] - want[key]) <= 1e-6, key


def test_cli_matches_jax_serve_script(world, capsys):
  """python -m mmt_tpu_torch.serve --device cpu on the exported .pth
  (--build_index with --query, then --query from the saved index)
  answers as scripts/serve.py on the msgpack it came from."""
  jax_serve = _load_by_path("jax_serve_script", REPO / "scripts" / "serve.py")
  root = world["root"]
  queries = []
  for q in QUERIES:
    queries += ["--query", q]
  common = ["--config", str(world["cfg_path"]), "--topk", "4"] + queries
  jax_serve.main(common + ["--checkpoint", str(world["msgpack"]),
                           "--build_index", str(root / "jax.msgpack")])
  want = [json.loads(l) for l in capsys.readouterr().out.splitlines()
          if l.startswith("{")]
  env = dict(os.environ, PYTHONPATH=str(REPO))
  port = ["--device", "cpu", "--checkpoint", str(world["pth"])] + common
  proc = subprocess.run(
      [sys.executable, "-m", "mmt_tpu_torch.serve"] + port
      + ["--build_index", str(root / "port.npz")],
      capture_output=True, text=True, env=env, cwd=REPO, timeout=300)
  assert proc.returncode == 0, proc.stderr[-2000:]
  built = [json.loads(l) for l in proc.stdout.splitlines()
           if l.startswith("{")]
  loaded = serve.main(port + ["--index", str(root / "port.npz")])
  for got in (built, loaded):
    assert [r["query"] for r in got] == [r["query"] for r in want] == QUERIES
    assert_hits_match([r["hits"] for r in want], [r["hits"] for r in got],
                      EXACT_TOL)


def test_strict_load_refuses_partial_and_foreign_checkpoints(world,
                                                             tmp_path):
  """A .pth missing one entry raises ValueError naming it; so does one
  with an entry the model has no place for, or a wrong shape; the
  reference's synthesized entries (poolers, num_batches_tracked,
  position_ids) in the exported .pth load."""
  ckpt = torch.load(world["pth"], map_location="cpu", weights_only=True)
  assert any("pooler" in k for k in ckpt["state_dict"])
  assert "txt_bert.embeddings.position_ids" in ckpt["state_dict"]
  model = world["model"]
  for what, edit, match in (
      ("missing", lambda sd: sd.pop("text_GU.rgb.fc.weight"),
       "text_GU.rgb.fc.weight"),
      ("foreign", lambda sd: sd.__setitem__("extra.head.weight",
                                            torch.zeros(2)),
       "extra.head.weight"),
      ("shape", lambda sd: sd.__setitem__("moe_fc_txt.s3d.bias",
                                          torch.zeros(3)),
       "moe_fc_txt.s3d.bias")):
    sd = dict(ckpt["state_dict"])
    edit(sd)
    path = tmp_path / f"{what}.pth"
    torch.save({**ckpt, "state_dict": sd}, path)
    with pytest.raises(ValueError, match=match.replace(".", r"\.")):
      serve.load_state_dict_strict(model, path)


def test_cli_flags(world, caplog, capsys, tmp_path):
  """--device defaults to cuda (no fallback to the CPU), --shard_index
  on one device serves the index unsharded and says so in one log line,
  and one of --index / --build_index is required."""
  base = ["--config", str(world["cfg_path"]), "--checkpoint",
          str(world["pth"])]
  index = tmp_path / "index.npz"
  serving.RetrievalIndex.build(
      world["model"], world["entry"]["loader"],
      dataset=world["entry"]["dataset"].datasets[0]).save(index)
  query = ["--index", str(index), "--query", QUERIES[0], "--topk", "3",
           "--device", "cpu"]
  with caplog.at_level("INFO", logger=serve.logger.name):
    sharded = serve.main(base + query + ["--shard_index"])
  lines = [r.getMessage() for r in caplog.records
           if "--shard_index" in r.getMessage()]
  assert lines == ["--shard_index: one device (cpu), the index unsharded"]
  assert sharded == serve.main(base + query)
  assert len(sharded[0]["hits"]) == 3
  capsys.readouterr()
  with contextlib.redirect_stderr(io.StringIO()):
    with pytest.raises(SystemExit):
      serve.main(base)
  if torch.cuda.is_available():
    pytest.skip("a card is present: the CUDA default runs in chip_smoke.py")
  with pytest.raises(RuntimeError, match="no CUDA device"):
    serve.main(base + ["--index", "x.npz"])
