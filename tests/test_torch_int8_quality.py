"""``python -m mmt_tpu_torch.int8_quality`` (the port of
scripts/int8_quality.py) on the CPU: at --videos 512 --queries 64 its
printed report is the JAX script's (same keys, the counts' fractions
exact, the score errors within 1e-6), and it runs on the card by
default.  On the card ``chip_smoke.py`` phase 12 runs it at 512 x 64 and
at its default 10,000 x 1,000.
"""

import json
import pathlib
import sys

import pytest
import torch

from mmt_tpu_torch import int8_quality

REPO = pathlib.Path(__file__).resolve().parent.parent
ARGS = ["--videos", "512", "--queries", "64"]


def test_report_equals_the_jax_script(capsys):
  sys.path.insert(0, str(REPO / "scripts"))
  import int8_quality as jax_script
  want = jax_script.main(ARGS)
  want_printed = json.loads(capsys.readouterr().out)
  got = int8_quality.main(ARGS + ["--device", "cpu"])
  assert json.loads(capsys.readouterr().out) == got
  assert want_printed == want and set(got) == set(want)
  for key, value in want.items():
    if key.startswith("score_"):
      assert abs(got[key] - value) <= 1e-6, key
    else:
      assert got[key] == value, key
  assert int8_quality.faults(got) == []


def test_faults_name_what_breaks_the_pinned_rule():
  rep = {"R1_fp32": 0.9, "R1_int8": 0.8, "R5_fp32": 1.0, "R5_int8": 1.0,
         "R10_fp32": 1.0, "R10_int8": 1.0, "top1_identical": 0.98,
         "overlap@10": 0.94, "score_mae_topk": 2e-3}
  assert int8_quality.faults(rep) == ["R1", "top1_identical", "overlap@10",
                                      "score_mae_topk"]


def test_it_runs_on_the_card_by_default():
  if torch.cuda.is_available():
    pytest.skip("a card is present: chip_smoke.py runs the default")
  with pytest.raises(RuntimeError, match="no CUDA device"):
    int8_quality.main(["--videos", "8", "--queries", "2"])
