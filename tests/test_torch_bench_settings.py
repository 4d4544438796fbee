"""bench.py's remaining settings in ``python -m mmt_tpu_torch.bench`` on
the CPU at the tiny widths: BENCH_DTYPE (the eval towers' compute type),
BENCH_TRAIN_BATCH (the step's batch and its key) and BENCH_TRAIN_OPT
(any registered optimizer; another name raises, as the JAX builder
does).  On the card ``chip_smoke.py`` runs fp32 / b128 / Ranger.
"""

import json

import pytest
import torch

from mmt_tpu_torch import bench

# bench.py:264-283's keys with BENCH_TRAIN_BATCH=4 (the train step on),
# less the TPU setup's own (vs_baseline, dispatch_rtt_s,
# videos_per_sec_device_only, pallas_similarity, pallas_ffn), plus the
# port's kernels, kernel_families and card.
JAX_KEYS = {"metric", "value", "unit", "vs_baseline", "latency_s_1kx1k",
            "dispatch_rtt_s", "videos_per_sec_device_only", "backend",
            "dtype", "pallas_similarity", "pallas_ffn", "train_step_ms_b4",
            "train_samples_per_sec_per_chip"}
TPU_ONLY = {"vs_baseline", "dispatch_rtt_s", "videos_per_sec_device_only",
            "pallas_similarity", "pallas_ffn"}


@pytest.fixture
def small(monkeypatch):
  for name, value in (("BENCH_VIDEOS", "4"), ("BENCH_BATCH", "2"),
                      ("BENCH_REPS", "1")):
    monkeypatch.setenv(name, value)
  monkeypatch.setattr(bench, "TRAIN_STEPS", 2)
  return monkeypatch


def test_fp32_b4_ranger(small, capsys):
  small.setenv("BENCH_DTYPE", "fp32")
  small.setenv("BENCH_TRAIN_BATCH", "4")
  small.setenv("BENCH_TRAIN_OPT", "Ranger")
  seen = {}
  stepper = bench.train_stepper

  def recorded(*args, **kw):
    model, batch, one = stepper(*args, **kw)
    seen.update(opt=kw["opt"], rows=len(batch["query_masks"]),
                dtype=model.txt_bert.compute_dtype)
    return model, batch, one

  small.setattr(bench, "train_stepper", recorded)
  evals = bench.build_full_eval

  def eval_dtype(*args, **kw):
    seen["eval_dtype"] = kw["compute_dtype"]
    return evals(*args, **kw)

  small.setattr(bench, "build_full_eval", eval_dtype)
  got = bench.main(["--device", "cpu", "--tiny"])
  assert json.loads(capsys.readouterr().out.strip().splitlines()[-1]) == got
  assert set(got) == JAX_KEYS - TPU_ONLY | {"kernels", "kernel_families",
                                            "card"}
  assert got["dtype"] == "fp32" and got["train_step_ms_b4"] > 0
  assert got["train_samples_per_sec_per_chip"] == pytest.approx(
      4e3 / got["train_step_ms_b4"])
  assert seen == {"opt": "Ranger", "rows": 4, "dtype": torch.bfloat16,
                  "eval_dtype": torch.float32}


def test_unknown_optimizer_and_dtype_raise(small):
  small.setenv("BENCH_TRAIN_OPT", "Adamax9")
  with pytest.raises(KeyError, match="unknown optimizer 'Adamax9'"):
    bench.main(["--device", "cpu", "--tiny"])
  small.setenv("BENCH_DTYPE", "fp16")
  with pytest.raises(ValueError, match="BENCH_DTYPE"):
    bench.main(["--device", "cpu", "--tiny"])
