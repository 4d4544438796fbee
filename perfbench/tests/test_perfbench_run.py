"""The harness against the program at test widths on the CPU (the
program's plain versions): the reference agrees, the result line has the
contract's keys, the import check holds."""

import json
import subprocess
import sys
import time

import pytest

from perfbench import checks, run
from perfbench.reference import model as ref_model
from perfbench.tests.tiny import tiny_cell

KEYS = ["correct", "attempted", "failed", "metrics", "device"]


@pytest.mark.parametrize("name", ["msrvtt-train-b32", "activitynet-train-b32",
                                  "msrvtt-eval-1k", "activitynet-eval-val1"])
def test_program_agrees_with_the_reference_at_test_widths(name):
  result, table = run.run_cell(tiny_cell(name), 0.2, 0, time.time())
  assert result["correct"], table
  assert all(t["value"] <= 1e-5 for t in table.values()), table


@pytest.mark.parametrize("trace", [0, 1])
def test_result_line_keys(trace):
  cell = tiny_cell("msrvtt-eval-1k")
  result, _ = run.run_cell(cell, 0.2, trace, time.time())
  assert list(result)[:5] == KEYS and list(result)[-1] == "checks"
  json.loads(json.dumps(result))
  if trace:
    assert {"busy_s", "window_s"} <= set(result["device"])
    assert set(result["breakdown"]) == {"device_ops", "idle_gaps"}
    assert set(result["metrics"]) == {"mfu.eval"}  # no device on the CPU
  else:
    assert set(result["metrics"]) == {"eval_videos_per_s", "setup_s"}


def test_a_cell_reports_its_own_end_to_end_metrics():
  result, _ = run.run_cell(tiny_cell("msrvtt-train-b32"), 0.2, 0, time.time())
  assert set(result["metrics"]) == {"train_samples_per_s",
                                    "train_step_p95_ms", "setup_s"}


@pytest.mark.parametrize("kind", ["train", "eval"])
def test_idle_share_takes_its_time_from_the_untraced_window(kind):
  class Slice:
    def busy_s(self):
      return 0.2  # 4 units of 50 ms, however long the traced slice

  class Reading:
    pass

  r = Reading()
  r.kind, r.slice, r.slice_units = kind, Slice(), 4
  r.window = {"units": 100, "seconds": 10.0}
  reader = run.metric_readers()[f"idle_share.{kind}"]
  assert reader.read(r) == pytest.approx(50.0)


def test_eval_set_up_runs_two_chunks_and_no_whole_eval(monkeypatch):
  from perfbench.mixes import eval as eval_mix

  cell = tiny_cell("msrvtt-eval-1k")  # 10 videos in chunks of 4, 4, 2
  chunks = []
  embed = eval_mix.evaluate.embed_corpus
  monkeypatch.setattr(eval_mix.evaluate, "embed_corpus",
                      lambda model, batches: chunks.append(
                          [len(b["query_masks"]) for b in batches])
                      or embed(model, batches))
  state = eval_mix.setup(cell)
  assert chunks == [[4, 2]] and state.last is None


def test_no_card_no_result(capsys):
  assert run.main(["--workload", "msrvtt-eval-1k", "--seed", "3",
                   "--seconds", "1"]) == 2
  assert capsys.readouterr().out == ""


def test_import_check_compares_whole_top_level_names(monkeypatch):
  for name in ("mmt_tpu_torch", "mmt_tpu_torch.ops", "jaxtyping",
               "flaxen"):
    monkeypatch.setitem(sys.modules, name, sys)
  assert run.forbidden_modules() == []
  for name in ("mmt_tpu", "jax.numpy", "jaxlib", "flax.linen"):
    monkeypatch.setitem(sys.modules, name, sys)
  assert run.forbidden_modules() == ["flax", "jax", "jaxlib", "mmt_tpu"]


def test_harness_and_reference_import_no_jax_and_the_reference_no_program():
  code = (
      "import sys\n"
      "import perfbench.reference.model, perfbench.reference.train\n"
      "import perfbench.reference.retrieval\n"
      "assert not [m for m in sys.modules if m.split('.')[0] == "
      "'mmt_tpu_torch'], 'the reference imports the program'\n"
      "import perfbench.run, perfbench.control, perfbench.trace\n"
      "import perfbench.mixes.train, perfbench.mixes.eval\n"
      "perfbench.run.metric_readers()\n"
      "print(perfbench.run.forbidden_modules())\n")
  out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, check=True)
  assert out.stdout.strip() == "[]"


def test_weights_load_strictly_into_the_program():
  from perfbench import inputs, port

  cfg = tiny_cell("activitynet-train-b32").cfg
  w = inputs.make_weights(cfg, 5, "cpu")
  assert set(w) == {n for n, _, _ in ref_model.param_spec(cfg)}
  port.build_model(cfg, w, "cpu")  # strict: raises on a missing name


def test_judge():
  outside, table = checks.judge({"a": 1.0, "b": float("nan"), "c": 0.5},
                                {"a": 1.0, "b": 1.0})
  assert outside == ["b", "c"] and table["b"]["value"] == "nan"
