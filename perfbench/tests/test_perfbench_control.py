"""The check's control on the card: the reference in TF32 put in the
program's place comes out not correct on three seeds.  The train cells
at their own size; the eval cells on a cut corpus of 256 videos, so the
test stays short (``python3 -m perfbench.control`` reads them at full
size)."""

import pytest
import torch

from perfbench import checks, control, run

CELLS = ["msrvtt-train-b32", "activitynet-train-b32", "msrvtt-eval-1k",
         "activitynet-eval-val1"]


@pytest.mark.card
@pytest.mark.parametrize("name", CELLS)
def test_tf32_control_is_not_correct(name):
  if not torch.cuda.is_available():
    pytest.skip("needs a CUDA card (TF32 exists only there)")
  for seed in (101, 202, 303):
    cell = run.Cell(name, seed, "cuda:0")
    if cell.mix.KIND == "eval":
      cell.traffic = dict(cell.traffic, videos=256)
    outside, table = checks.judge(control.control_numbers(cell), cell.limits)
    assert outside, table
