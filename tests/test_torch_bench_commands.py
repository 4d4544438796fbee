"""The port's measurement commands (``python -m mmt_tpu_torch.<name>``) at
``--device cpu --tiny`` on small sizes: each prints one JSON line last
with the JAX script's keys (scripts/bench_geometry.py,
bench_sustained.py, bench_serving.py) and the port's "card"; each runs on
the card by default and raises without one.  Sizes: 4 videos in chunks
of 2 and 2 chained train steps a geometry; 64 samples over 20 videos;
an index of 300 videos, 4 single queries and 2 batches of 64.
"""

import json

import pytest
import torch

from mmt_tpu_torch import bench, bench_geometry, bench_serving, bench_sustained

GEOMETRY_KEYS = {"geometry", "modalities", "max_expert_tokens", "eval_chunk",
                 "n_videos", "eval_wall_s", "eval_videos_per_sec_per_chip",
                 "train_batch", "train_step_ms",
                 "train_samples_per_sec_per_chip", "backend", "routing",
                 "kernel_families", "card"}
SUSTAINED_KEYS = {"metric", "batch", "workers", "samples", "wall_s",
                  "samples_per_sec", "step_ms_implied", "dispatch_rtt_s",
                  "loss", "backend", "kernel_families", "card"}
PRESTAGE_KEYS = {"prestage_batches", "batch_mbytes", "h2d_ms_per_batch",
                 "bare_per_step_dispatch_ms"}
PCT = {"p50", "p90", "p99", "max"}


def _last_line(capsys):
  return json.loads(capsys.readouterr().out.strip().splitlines()[-1])


def test_bench_geometry(monkeypatch, capsys):
  monkeypatch.setenv("BENCH_VIDEOS", "5")   # 4: a whole number of chunks
  monkeypatch.setenv("BENCH_BATCH", "2")
  monkeypatch.setenv("BENCH_REPS", "1")
  monkeypatch.setattr(bench, "TRAIN_STEPS", 2)
  lines = bench_geometry.main(["--device", "cpu", "--tiny"])
  printed = [json.loads(x) for x in capsys.readouterr().out.splitlines()]
  assert printed == lines
  assert [x["geometry"] for x in lines] == ["activitynet", "howto100m"]
  for line in lines:
    assert set(line) == GEOMETRY_KEYS
    geom = bench_geometry.GEOMETRIES[line["geometry"]]
    assert line["n_videos"] == 4 and line["eval_chunk"] == 2
    assert line["train_batch"] == geom["train_batch"]
    assert line["backend"] == "cpu" and line["card"] is None
    assert line["eval_wall_s"] > 0 and line["train_step_ms"] > 0
    assert not line["routing"]["kernels"]
  # The video rows of each mode: chunk or batch x (1 + M (1 + L)).
  assert "train video 6496 x 64" in lines[0]["routing"]["gemm_tile_rows"]
  assert "train video 4032 x 64" in lines[1]["routing"]["gemm_tile_rows"]


def test_bench_sustained(capsys):
  out = bench_sustained.main(["--device", "cpu", "--tiny", "--samples", "64",
                              "--videos", "20", "--prestage", "2"])
  assert _last_line(capsys) == out
  assert set(out) == SUSTAINED_KEYS | PRESTAGE_KEYS
  assert out["samples"] == 64 and out["batch"] == 32
  assert out["prestage_batches"] == 2 and out["batch_mbytes"] > 0
  assert out["loss"] == out["loss"] and out["wall_s"] > 0


def test_bench_serving(monkeypatch, capsys):
  monkeypatch.setattr(bench_serving, "N_VIDEOS", 300)
  monkeypatch.setattr(bench_serving, "N_INTERACTIVE", 4)
  monkeypatch.setattr(bench_serving, "N_BULK", 2)
  summary = bench_serving.main(["--device", "cpu", "--tiny"])
  assert _last_line(capsys) == summary
  assert set(summary) == {"index", "params_m", "fp32", "int8", "card"}
  assert summary["index"] == 300
  for label in ("fp32", "int8"):
    entry = summary[label]
    assert set(entry) == {"batch1_ms", "batch64_ms", "batch64_qps",
                          "server_statz"}
    assert set(entry["batch1_ms"]) == set(entry["batch64_ms"]) == PCT
    # The server's reservoir: 3 warm GETs and POSTs, then 4 + 2.
    assert entry["server_statz"]["count"] == 12


def test_statz_must_count_the_requests(monkeypatch, tmp_path):
  """A server that misses a request fails the measurement."""
  import numpy as np
  from mmt_tpu_torch import flagship, serving

  model = flagship.flagship_model(device="cpu", tiny=True)
  index = bench_serving.synthetic_index(20, 7, model.same_dim, "cpu")
  engine = serving.RetrievalEngine(
      model, bench_serving.vocab_tokenizer(tmp_path), index)
  real = serving._ServerStats.record
  seen = []

  def drop_one(self, latency_s, n_queries):
    seen.append(1)
    if len(seen) != 8:
      real(self, latency_s, n_queries)

  monkeypatch.setattr(serving._ServerStats, "record", drop_one)
  with pytest.raises(RuntimeError, match="statz counted"):
    bench_serving.measure(engine, np.random.RandomState(0), 2, 1)


@pytest.mark.skipif(torch.cuda.is_available(), reason="a card is present")
@pytest.mark.parametrize("main", [bench_geometry.main, bench_sustained.main,
                                  bench_serving.main])
def test_commands_default_to_the_card(main):
  with pytest.raises(RuntimeError, match="no CUDA device"):
    main([])
