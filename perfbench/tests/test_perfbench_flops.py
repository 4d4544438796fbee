"""The yardstick's counts held to hand counts at the flagship's shapes
(configs/msrvtt-jsfusion.json: 7 experts of 30 rows, 30 words)."""

import pytest

from perfbench import flops, run


@pytest.fixture(scope="module")
def msrvtt():
  return run.Cell("msrvtt-train-b32", 1, "cpu").cfg


def test_forward_counts_by_hand(msrvtt):
  # Text tower: 30 tokens x 12 layers x (8 H^2 + 4 H I + 4 T H) at
  # H 768, I 3072; then 7 experts' GEU (768 -> 512, 512 -> 512) and MoE
  # head (768 -> 1).
  text = 30 * 12 * (8 * 768 ** 2 + 4 * 768 * 3072 + 4 * 30 * 768)
  heads = 7 * (2 * 768 * 512 + 2 * 512 * 512 + 2 * 768)
  assert flops.caption_flops(msrvtt) == text + heads == 5_138_442_752
  # Video: 31 rows (pooled + 30) of each expert reduced to 512 (the
  # experts' widths sum to 6,520), then 218 tokens x 4 layers at H 512.
  reduce = 31 * 2 * 512 * 6520
  tower = 218 * 4 * (8 * 512 ** 2 + 4 * 512 * 3072 + 4 * 218 * 512)
  assert flops.video_flops(msrvtt) == reduce + tower == 7_911_153_664


def test_train_step_and_eval_by_hand(msrvtt):
  sims = 2 * 32 * 32 * 7 * 513
  assert flops.train_step_flops(msrvtt, 32) == 3 * (
      32 * (7_911_153_664 + 5_138_442_752) + sims) == 1_252_783_319_040
  assert flops.eval_flops(msrvtt, 1000) == (
      1000 * (7_911_153_664 + 5_138_442_752) + 2 * 1000 * 1000 * 7 * 513)


def test_ffn_bound_is_chip_smokes():
  # chip_smoke.py's fp32 bounds of B2 at the b32 shapes (operations).
  assert flops.ffn_bound_s("B2", 6976, 512, 3072) * 1e3 == pytest.approx(
      0.6551, abs=1e-4)
  assert flops.ffn_bound_s("B3", 960, 768, 3072) * 1e3 == pytest.approx(
      0.1352, abs=1e-4)
  # A thin call is bound by its bytes: 4 R H I FLOP against 4 bytes of
  # each tensor element.
  r, h, i = 8, 512, 3072
  elems = 2 * r * h + 2 * h * i + i + 3 * h
  assert flops.ffn_bound_s("B1", r, h, i) == pytest.approx(
      4 * elems / flops.PEAK_BYTES)


def test_ffn_calls(msrvtt):
  step = flops.ffn_calls_train_step(msrvtt, 32)
  assert len(step) == 2 * (12 + 4)
  assert ("B2", 960, 768, 3072) in step and ("B3", 6976, 512, 3072) in step
  ev = flops.ffn_calls_eval(msrvtt, [32] * 31 + [8])
  assert len(ev) == 32 * 16 and ("B1", 8 * 218, 512, 3072) in ev
