"""The per-family kernel switches (mmt_tpu_torch/ops/__init__.py), the
port's counterpart of mmt_tpu/ops/__init__.py:enable_tpu_default_kernels
and of bench.py's BENCH_PALLAS / BENCH_PALLAS_FFN.

The environment -> families map; ``use_kernel`` per family on a stand-in
tensor that says it lies on the card; each of ``cli.main``, ``serve.main``
and ``bench_sustained.main`` running its work under the switches; and
``bench`` / ``bench_geometry`` at ``--device cpu --tiny`` reading their
switches and naming each family's path in their JSON lines (the CPU
passed off as a card for the families' report, its tensors still taking
the plain versions).
"""

import contextlib
import json
import pathlib
import sys
import types

import pytest

from mmt_tpu_torch import (bench, bench_geometry, bench_sustained, cli, ops,
                           serve)

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent))
from test_train_e2e import make_config  # noqa: E402

ON_CARD = types.SimpleNamespace(is_cuda=True)
ON_CPU = types.SimpleNamespace(is_cuda=False)
FFN, SIM = ops.SWITCHES["ffn"], ops.SWITCHES["similarity"]
# (environment, the families it sends to the plain versions)
SETTINGS = [({}, ()),
            ({FFN: "0"}, ("ffn",)),
            ({SIM: "0"}, ("similarity",)),
            ({FFN: "0", SIM: "0"}, ("ffn", "similarity"))]


def _on_card(families=ops.FAMILIES):
  return {f: ops.use_kernel(ON_CARD, f) for f in families}


@pytest.mark.parametrize("environ, plain", SETTINGS)
def test_environment_to_families(environ, plain):
  assert ops.switched_families(environ) == plain
  assert ops.switched_families({**environ, "BENCH_PALLAS": "0"}) == plain
  with ops.environment_switches(environ) as got:
    assert got == plain
    assert _on_card() == {f: f not in plain for f in ops.FAMILIES}
  assert _on_card() == dict.fromkeys(ops.FAMILIES, True)


def test_the_jax_values():
  """As the JAX package reads them: "1" or unset keeps the kernels, any
  other value sends the family to its plain versions."""
  assert ops.switched_families({FFN: "1", SIM: "1"}) == ()
  assert ops.switched_families({FFN: "false"}) == ("ffn",)
  assert ops.SWITCHES == {"ffn": "MMT_TPU_PALLAS_FFN",
                          "similarity": "MMT_TPU_PALLAS_SIMILARITY"}


def test_use_kernel_per_family():
  assert _on_card() == {"ffn": True, "similarity": True, "ranks": True,
                        "moe": True}
  assert not any(ops.use_kernel(ON_CPU, f) for f in ops.FAMILIES)
  with ops.plain_versions("ffn"):
    assert _on_card() == {"ffn": False, "similarity": True, "ranks": True,
                          "moe": True}
    with ops.plain_versions("similarity"):
      # The fused ranks keep their kernel, as in the JAX package.
      assert _on_card() == {"ffn": False, "similarity": False,
                            "ranks": True, "moe": True}
    assert _on_card() == {"ffn": False, "similarity": True, "ranks": True,
                          "moe": True}
  with ops.plain_versions():
    assert _on_card() == dict.fromkeys(ops.FAMILIES, False)
    assert ops.kernel_families("cuda:0") == dict.fromkeys(ops.FAMILIES,
                                                          False)
  assert ops.kernel_families("cuda") == dict.fromkeys(ops.FAMILIES, True)
  assert ops.kernel_families("cpu") == dict.fromkeys(ops.FAMILIES, False)
  with pytest.raises(ValueError, match="unknown kernel families"):
    with ops.plain_versions("attention"):
      pass
  assert _on_card() == dict.fromkeys(ops.FAMILIES, True)


@pytest.mark.parametrize("environ, plain", SETTINGS)
def test_entry_points_apply_the_switches(environ, plain, monkeypatch,
                                         tmp_path):
  """cli.main, serve.main and bench_sustained.main each run their work
  with exactly the switched families plain, and leave no switch behind."""
  for name, value in environ.items():
    monkeypatch.setenv(name, value)
  want = {f: f not in plain for f in ops.FAMILIES}
  seen = {}

  def record(what, result=None):
    def stand_in(*args, **kw):
      seen[what] = _on_card()
      return result
    return stand_in

  cfg = tmp_path / "cfg.json"
  cfg.write_text(json.dumps(make_config(tmp_path, tmp_path / "data",
                                        tmp_path / "exps")))
  monkeypatch.setattr(cli, "train", record("cli"))
  cli.main(["--config", str(cfg), "--device", "cpu"])
  monkeypatch.setattr(serve, "_serve", record("serve"))
  serve.main(["--config", str(cfg), "--checkpoint", "x.pth", "--index",
              "x.npz", "--device", "cpu"])
  monkeypatch.setattr(bench_sustained, "run", record("bench_sustained", {}))
  bench_sustained.main(["--device", "cpu"])
  assert seen == dict.fromkeys(("cli", "serve", "bench_sustained"), want)
  assert _on_card() == dict.fromkeys(ops.FAMILIES, True)


@pytest.fixture
def card_report(monkeypatch):
  """The families' report as on a card (the CPU tensors still take the
  plain versions); returns the plain families each kernel path was
  given."""
  given = []

  def kernel_path(device, plain=()):
    given.append(tuple(plain))
    return (ops.plain_versions(*plain) if plain
            else contextlib.nullcontext())

  monkeypatch.setattr(bench, "kernel_path", kernel_path)
  monkeypatch.setattr(ops, "kernel_families", lambda device: {
      f: ops.use_kernel(ON_CARD, f) for f in ops.FAMILIES})
  for name, value in (("BENCH_VIDEOS", "4"), ("BENCH_BATCH", "2"),
                      ("BENCH_REPS", "1"), ("BENCH_TRAIN", "0")):
    monkeypatch.setenv(name, value)
  monkeypatch.setattr(bench, "TRAIN_STEPS", 1)
  return given


BENCH_SETTINGS = [({}, ()),
                  ({"BENCH_PALLAS": "0"}, ("similarity",)),
                  ({"BENCH_PALLAS_FFN": "0"}, ("ffn",)),
                  ({"BENCH_PALLAS": "0", "BENCH_PALLAS_FFN": "0"},
                   ("ffn", "similarity")),
                  ({"BENCH_KERNELS": "0"}, ops.FAMILIES)]


@pytest.mark.parametrize("environ, plain", BENCH_SETTINGS)
def test_bench_reads_its_switches(environ, plain, card_report, monkeypatch,
                                  capsys):
  for name, value in environ.items():
    monkeypatch.setenv(name, value)
  assert bench.plain_families() == plain
  got = bench.main(["--device", "cpu", "--tiny"])
  assert json.loads(capsys.readouterr().out.strip().splitlines()[-1]) == got
  want = {f: f not in plain for f in ops.FAMILIES}
  assert card_report == [plain]
  assert got["kernel_families"] == want
  assert got["kernels"] is (not plain)


@pytest.mark.parametrize("environ, plain", BENCH_SETTINGS[1:3])
def test_bench_geometry_reads_its_switches(environ, plain, card_report,
                                           monkeypatch, capsys):
  """One geometry's eval at 4 videos; its train step stubbed (``bench``'s
  own, which test_torch_bench_commands.py runs)."""
  for name, value in environ.items():
    monkeypatch.setenv(name, value)
  monkeypatch.setattr(bench, "train_stepper", lambda *a, **kw: (0, 0, 0))
  monkeypatch.setattr(bench, "chained_step_ms", lambda one, reps: 1.0)
  lines = bench_geometry.main(["howto100m", "--device", "cpu", "--tiny"])
  printed = [json.loads(x) for x in capsys.readouterr().out.splitlines()]
  assert printed == lines and card_report == [plain]
  line, = lines
  assert line["kernel_families"] == {f: f not in plain
                                     for f in ops.FAMILIES}
  assert line["routing"]["kernels"] is False
