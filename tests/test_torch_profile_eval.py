"""``python -m mmt_tpu_torch.profile_eval`` (the port of
scripts/profile_eval.py) on the CPU at the tiny widths: both modes, the
rollup against the total, the CSV and the trace; the categories of the
kernels csrc/ defines and of library names; a session whose kernels
record fewer launches than the counters moved (the profiler stubbed)
runs again, then raises.  On the card ``chip_smoke.py`` runs both modes
at full width.
"""

import csv
import json
import pathlib
import re
import types

import pytest
import torch

from mmt_tpu_torch import profile_eval
from mmt_tpu_torch.ops import ffn

CSRC = pathlib.Path(__file__).resolve().parent.parent / "mmt_tpu_torch" / "csrc"


def csrc_kernels():
  """The name of every __global__ function under csrc/."""
  names = set()
  for src in CSRC.iterdir():
    text = src.read_text()
    for m in re.finditer(r"__global__\s+void\s+(?:__launch_bounds__\([^)]*\)"
                         r"\s*)?(\w+)\s*\(", text):
      names.add(m.group(1))
  return names


@pytest.mark.parametrize("mode", ["eval", "train"])
def test_both_modes_on_the_cpu(mode, monkeypatch, tmp_path, capsys):
  monkeypatch.setenv("BENCH_VIDEOS", "4")
  monkeypatch.setenv("BENCH_BATCH", "2")
  monkeypatch.setenv("BENCH_TRAIN_BATCH", "4")
  out = tmp_path / "rows.csv"
  res = profile_eval.main(["--mode", mode, "--reps", "2", "--steps", "2",
                           "--device", "cpu", "--tiny", "--top", "5",
                           "--csv", str(out), "--logdir",
                           str(tmp_path / "trace")])
  printed = capsys.readouterr().out
  assert res["mode"] == mode and res["runs"] == 2 and res["device"] == "cpu"
  assert "CPU ops' self time" in printed and "not measured" in printed
  assert res["idle"] is None and res["wall_ms"] > 0
  assert res["launches"] == dict.fromkeys(profile_eval.LAUNCH_MARKERS, 0)
  total = res["device_ms"]
  assert total > 0
  assert sum(r["ms_per_run"] for r in res["rows"]) == pytest.approx(
      total, rel=1e-6)
  assert sum(res["rollup"].values()) == pytest.approx(total, rel=1e-6)
  assert sum(r["share"] for r in res["rows"]) == pytest.approx(1, rel=1e-6)
  assert any(r["category"] == "library matmul" for r in res["rows"])
  with open(out) as fh:
    table = list(csv.reader(fh))
  assert table[0] == ["name", "category", "ms_per_run", "share", "per_run",
                      "key"]
  assert len(table) == len(res["rows"]) + 1
  trace = json.loads(pathlib.Path(res["trace"]).read_text())
  assert any(str(e.get("name", "")).startswith("aten::")
             for e in trace["traceEvents"])
  # The program's spans, host ms a run; no device ms on the CPU.
  top = {"eval": "mmt.eval", "train": "mmt.step"}[mode]
  assert top in res["spans"] and "mmt.tower.text" in res["spans"]
  assert all(t["device_ms"] is None for t in res["spans"].values())
  assert res["spans"][top]["host_ms"] == pytest.approx(
      max(t["host_ms"] for t in res["spans"].values()))
  assert 0 < res["spans"][top]["host_ms"] <= res["wall_ms"]
  assert "== program spans" in printed
  assert not any(r["key"].startswith("mmt.") for r in res["rows"])


def test_categories_of_the_kernels_and_library_names():
  kernels = csrc_kernels()
  assert len(kernels) == 16
  assert kernels == set(profile_eval.CUDA_FFN_KERNELS
                        + profile_eval.CUDA_SIM_KERNELS
                        + profile_eval.CUDA_MOE_KERNELS)
  for name in kernels:
    want = ("cuda ffn (B1-B3, B6, B7)" if name.startswith("ffn_")
            else "cuda moe experts" if name.startswith("moe_grouped_")
            else "cuda similarity/rank (B4, B5)")
    assert profile_eval.category(f"void (anonymous namespace)::{name}"
                                 "(float const*, int)") == want, name
  cases = {
      "sm80_xmma_gemm_f32f32_f32f32_f32_nt_n_tilesize64x64x8_stage3": (
          "library matmul"),
      "void cutlass::Kernel2<cutlass_80_simt_sgemm_256x128_8x4_nt_align1>"
      "(cutlass_80_simt_sgemm_256x128_8x4_nt_align1::Params)": (
          "library matmul"),
      "void gemv2T_kernel_val<int, int, float, float, float, float, 128>":
          "library matmul",
      "nvjet_tst_192x192_64x3_2x1_v_bz_coopA_TNT": "library matmul",
      "Memcpy HtoD (Pinned -> Device)": "copy",
      "Memset (Device)": "copy",
      "void at::native::unrolled_elementwise_kernel<at::native::direct_copy_"
      "kernel_cuda(at::TensorIteratorBase&)::{lambda()#3}>": "copy",
      "void at::native::(anonymous namespace)::CatArrayBatchedCopy<float>":
          "data formatting",
      "void at::native::index_elementwise_kernel<128, 4>": "data formatting",
      "void at::native::reduce_kernel<128, 4>": "other",
  }
  for name, want in cases.items():
    assert profile_eval.category(name) == want, name
  # The GEMM route's kernel is the port's, though its name has "gemm".
  assert profile_eval.category(
      "void mmt_gemm::ffn_tn_gemm_kernel<64, (anonymous namespace)::"
      "ResidualEpilogue>(CUtensorMap_st, CUtensorMap_st, int)") == (
          "cuda ffn (B1-B3, B6, B7)")


def _event(key, count):
  return types.SimpleNamespace(key=key, count=count, self_device_time_total=1,
                               device_type=None, is_user_annotation=False)


B1_RESIDUAL = ("void mmt_gemm::ffn_tn_gemm_kernel<64, (anonymous namespace)::"
               "ResidualEpilogue>(CUtensorMap_st, CUtensorMap_st, int)")


def test_launch_markers_count_one_kernel_a_launch():
  events = [
      _event(B1_RESIDUAL, 12),
      _event("void mmt_gemm::ffn_tn_gemm_kernel<128, (anonymous namespace)::"
             "ResidualEpilogue>(CUtensorMap_st)", 4),
      _event("void mmt_gemm::ffn_tn_gemm_kernel<64, (anonymous namespace)::"
             "GeluEpilogue>(CUtensorMap_st)", 16),
      _event("void (anonymous namespace)::ffn_ln_rows_kernel<false>(float*)",
             16),
      _event("void mmt_gemm::ffn_tn_gemm_kernel<64, (anonymous namespace)::"
             "DropResidualEpilogue>(CUtensorMap_st)", 5),
      _event("void (anonymous namespace)::ffn_block_f32_kernel<((anonymous "
             "namespace)::Mode)0>(float const*)", 3),
      _event("void (anonymous namespace)::ffn_block_bf16_kernel<((anonymous "
             "namespace)::Mode)1>(float const*)", 2),
      _event("void (anonymous namespace)::ffn_block_bf16_kernel<((anonymous "
             "namespace)::Mode)3>(float const*)", 9),
      _event("(anonymous namespace)::ffn_ln_bwd_rows_kernel(float const*)", 7),
      _event("(anonymous namespace)::ffn_transpose_bf16_kernel(unsigned short"
             " const*)", 7),
      _event("void (anonymous namespace)::moe_similarity_kernel<Tile64>(float"
             " const*)", 1),
      _event("void k_major_kernel<>(float const*)", 2),
      _event("void (anonymous namespace)::fused_ranks_kernel<Tile128>(float"
             " const*)", 2),
  ]
  assert profile_eval.recorded_launches(events) == {
      "B1": 19, "B2": 7, "B3": 7, "B4": 1, "B5": 2}


# The fp32 route's kernels as the profiler names them: the SIMT GEMM by
# its tile, B-operand layout and epilogue; the row passes by compute type.
SGEMM = ("void mmt_sgemm::ffn_sgemm_kernel<{}, {}, (anonymous namespace)::"
         "{}>(float const*, float const*, int, int, int, (anonymous "
         "namespace)::{})")


@pytest.mark.parametrize("tile,layout,epilogue", [
    (128, "true", "GeluEpilogue<float>"),
    (64, "true", "GeluInterEpilogue<float>"),
    (32, "true", "ResidualEpilogue"),
    (128, "false", "DgeluEpilogue<float>"),
    (64, "false", "AccumulateEpilogue")])
def test_the_fp32_route_is_the_ports_ffn_not_library_matmul(tile, layout,
                                                             epilogue):
  """The SIMT GEMM's name holds "gemm", which files a library's matmul:
  it is filed with the port's FFN kernels first."""
  name = SGEMM.format(tile, layout, epilogue, epilogue)
  assert profile_eval.category(name) == "cuda ffn (B1-B3, B6, B7)"
  assert profile_eval.short_kernel_name(name).startswith("ffn_sgemm_kernel<")


def test_launch_markers_count_one_kernel_a_launch_on_the_fp32_route():
  """B1 and B2 on the fp32 route: GEMM 1, GEMM 2 and the row pass, of
  which GEMM 2 (its residual epilogue) marks a launch; B3: the row pass,
  GEMM A and GEMM B, of which the row pass marks it."""
  row = "void (anonymous namespace)::{}<{}>(float const*)"
  b1, b2, b3 = 3, 5, 7
  events = [
      _event(SGEMM.format(128, "true", "GeluEpilogue<float>", "x"), b1),
      _event(SGEMM.format(128, "true", "ResidualEpilogue", "x"), b1),
      _event(row.format("ffn_ln_rows_kernel", "false, float"), b1),
      _event(SGEMM.format(32, "true", "GeluInterEpilogue<float>", "x"), b2),
      _event(SGEMM.format(32, "true", "DropResidualEpilogue", "x"), b2),
      _event(row.format("ffn_ln_rows_kernel", "true, float"), b2),
      _event(row.format("ffn_ln_bwd_rows_kernel", "float"), b3),
      _event(SGEMM.format(64, "false", "DgeluEpilogue<float>", "x"), b3),
      _event(SGEMM.format(64, "false", "AccumulateEpilogue", "x"), b3),
  ]
  assert profile_eval.recorded_launches(events) == {
      "B1": b1, "B2": b2, "B3": b3, "B4": 0, "B5": 0}


def test_a_short_launch_count_runs_again_then_raises(monkeypatch, capsys):
  """Each session launches 16 B1 (the counter moved by the work itself)
  and the stubbed profiler records 15: PROFILE_TRIES sessions, then
  RuntimeError; a session recording them all returns at once."""
  sessions = []

  def run():
    sessions.append(1)
    ffn.ffn_block_cuda.launches += 16

  recorded = {"n": 15}
  monkeypatch.setattr(profile_eval, "device_events",
                      lambda prof: [_event(B1_RESIDUAL, recorded["n"])])
  with pytest.raises(RuntimeError, match="missed launches"):
    profile_eval.session(run, "cpu")
  assert len(sessions) == profile_eval.PROFILE_TRIES
  assert "run again" in capsys.readouterr().err
  sessions.clear()
  recorded["n"] = 16
  _, events, wall_ms, launched = profile_eval.session(run, "cpu")
  assert len(sessions) == 1 and wall_ms >= 0 and len(events) == 1
  assert launched == dict(dict.fromkeys(profile_eval.LAUNCH_MARKERS, 0),
                          B1=16)
  recorded["n"] = 17
  with pytest.raises(RuntimeError, match="more launches"):
    profile_eval.session(run, "cpu")


def _timed(name, start, end, device_type, corr=0, annotation=False):
  return types.SimpleNamespace(
      name=name, id=corr, device_type=device_type,
      is_user_annotation=annotation,
      time_range=types.SimpleNamespace(start=start, end=end))


def fake_session():
  """A train step's events on the profiler's clock (us): the step's span
  and its backward on the host, two launches (the second from autograd's
  thread while the main thread waits in the backward), an op whose id
  happens to equal a launch's, and three device activities, two of them
  overlapping, with an annotation over them."""
  from torch.autograd import DeviceType

  cpu, cuda = DeviceType.CPU, DeviceType.CUDA
  return types.SimpleNamespace(events=lambda: [
      _timed("mmt.step", 0, 100, cpu, 1, True),
      _timed("mmt.step.backward", 50, 100, cpu, 2, True),
      _timed("cudaLaunchKernel", 10, 12, cpu, 7),
      _timed("cudaLaunchKernel", 60, 62, cpu, 8),
      _timed("aten::mm", 200, 210, cpu, 7),
      _timed("gemm_kernel", 20, 40, cuda, 7),
      _timed("ffn_ln_bwd_rows_kernel", 30, 55, cuda, 8),
      _timed("Memset (Device)", 300, 305, cuda, 9),
      _timed("mmt.step", 20, 55, cuda, 1, True),
  ])


def test_idle_share_takes_the_union_of_the_device_activities():
  """Overlapping activities count once: busy 35 + 5 us, where the sum of
  their times reads 50."""
  assert profile_eval.union_us([(20, 40), (30, 55), (300, 305)]) == 40
  assert profile_eval.busy_us(fake_session()) == 40


def test_a_span_holds_the_device_work_launched_inside_it():
  """Each span's device ms: the union of the activities whose launch lies
  inside it, from either thread; an op's id matching a launch's does not
  count, and neither does a device activity with no launch."""
  spans = profile_eval.span_rollup(fake_session(), "cuda", runs=1)
  assert spans == {
      "mmt.step": {"host_ms": 0.1, "device_ms": 0.035},
      "mmt.step.backward": {"host_ms": 0.05, "device_ms": 0.025}}
  cpu = profile_eval.span_rollup(fake_session(), "cpu", runs=2)
  assert cpu["mmt.step"] == {"host_ms": 0.05, "device_ms": None}


def test_it_runs_on_the_card_by_default():
  if torch.cuda.is_available():
    pytest.skip("a card is present: chip_smoke.py runs the default")
  with pytest.raises(RuntimeError, match="no CUDA device"):
    profile_eval.main([])
