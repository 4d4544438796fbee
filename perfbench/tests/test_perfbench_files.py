"""The benchmark is driven by its data files: every cell, configuration,
traffic mix and per-layer metric is a file found by its name."""

import json
import pathlib
import shutil

import pytest

from perfbench import run

HERE = pathlib.Path(run.__file__).resolve().parent
BENCHMARK = json.loads((HERE.parent / "BENCHMARK.json").read_text())
WORKLOADS = sorted(p.stem for p in (HERE / "workloads").glob("*.json"))


@pytest.mark.parametrize("name", WORKLOADS)
def test_workload_names_a_known_configuration_and_mix(name):
  cell = run.Cell(name, 1, "cpu")
  assert cell.cfg["name"] == cell.config_name
  assert cell.mix.KIND == cell.traffic["mix"]
  assert cell.chips == 1
  for key in ("setup", "window", "end_to_end", "slice_work", "results",
              "reference", "numbers", "unit_flops", "ffn_calls"):
    assert callable(getattr(cell.mix, key))


def test_benchmark_json_lists_the_workload_files():
  listed = {w["name"]: w for w in BENCHMARK["workloads"]}
  assert set(listed) <= set(WORKLOADS)
  for name, w in listed.items():
    cell = run.Cell(name, 1, "cpu")
    assert (w["config"], w["traffic"], w["chips"], w["why"]) == (
        cell.config_name, cell.traffic_name, cell.chips, cell.why)
  for m in BENCHMARK["end_to_end"]:
    cells = m.get("workloads", list(listed))
    for name in listed:
      in_cell = m["name"] == "setup_s" or m["name"] in run.Cell(
          name, 1, "cpu").end_to_end
      assert in_cell == (name in cells), (m["name"], name)
  for c in BENCHMARK["configs"]:
    cfg = json.loads((HERE.parent / c["file"]).read_text())
    assert cfg["source"] == c["source"] and cfg["reduced"] == c["reduced"]


def test_every_per_layer_metric_has_its_reader():
  readers = run.metric_readers()
  assert set(readers) == {m["name"] for m in BENCHMARK["per_layer"]}
  for m in BENCHMARK["per_layer"]:
    assert readers[m["name"]].UNIT == m["unit"]
    # A reader reads the cells of one kind, the kind its name ends in.
    kinds = {run.Cell(w, 1, "cpu").mix.KIND for w in m["workloads"]}
    assert kinds == {m["name"].rsplit(".", 1)[1]}


def test_a_workload_added_as_a_file_is_found_without_an_edit(tmp_path):
  for kind in ("configs", "traffic", "metrics"):
    shutil.copytree(HERE / kind, tmp_path / kind)
  (tmp_path / "workloads").mkdir()
  (tmp_path / "traffic" / "eval-2k.json").write_text(json.dumps(
      {"mix": "eval", "videos": 2000, "chunk": 64, "captions_per_video": 1}))
  (tmp_path / "workloads" / "activitynet-eval-2k.json").write_text(
      json.dumps({"config": "activitynet-val1", "traffic": "eval-2k",
                  "chips": 1, "why": "a cell added as data alone",
                  "end_to_end": ["eval_videos_per_s"], "limits": {}}))
  (tmp_path / "metrics" / "videos_seen.eval.py").write_text(
      'UNIT = "videos"\n\ndef read(r):\n'
      '  return r.window["units"] * r.cell.traffic["videos"]\n')
  cell = run.Cell("activitynet-eval-2k", 1, "cpu", root=tmp_path)
  assert cell.traffic["videos"] == 2000 and cell.mix.KIND == "eval"
  assert cell.mix.chunk_sizes(cell.traffic) == [64] * 31 + [16]
  assert "videos_seen.eval" in run.metric_readers(tmp_path)
