"""Device-time breakdown of the benchmark's programs, by kernel and by
category.

Port of scripts/profile_eval.py.  Runs the program ``python -m
mmt_tpu_torch.bench`` times under torch.profiler (the CPU and CUDA
activities) and prints the top device activities by self time per run,
a rollup by category, a rollup by the program's spans (host and device
ms a run of each ``mmt.*`` span, ``utils.timing.span``), the wall of the
traced runs, the device's idle share (1 - the union of the device
activities' intervals over the wall, which holds the profiler's own host
work) and where the raw trace is:

  python -m mmt_tpu_torch.profile_eval                 # eval-1k, the card
  python -m mmt_tpu_torch.profile_eval --mode train    # the b32 step
  python -m mmt_tpu_torch.profile_eval --top 40 --csv out.csv --logdir D
  BENCH_VIDEOS=20 BENCH_BATCH=10 \\
      python -m mmt_tpu_torch.profile_eval --device cpu --tiny

``--mode eval`` builds ``bench.build_full_eval`` and runs it once outside
the trace, then ``--reps`` times inside it; ``--mode train`` builds
``bench.train_stepper``'s step, runs two steps outside the trace (on
the card ``train_step`` captures its graph at the second), then
``--steps`` (``bench.TRAIN_STEPS``, 20) chained steps inside it, the
denominator being the number of steps.  The profiler's own processing
takes seconds for each run traced.  Both read bench's settings (BENCH_VIDEOS, BENCH_BATCH,
BENCH_DTYPE, BENCH_TRAIN_BATCH, BENCH_TRAIN_OPT and the kernel switches
BENCH_KERNELS, BENCH_PALLAS, BENCH_PALLAS_FFN).
``--logdir`` keeps the session as a Chrome trace (``<dir>/trace.json``,
``utils.timing.export_trace``); without it no trace is written.

The device activities are the kernels and memory copies and sets, not
the GPU user annotations (``device_events``).  torch.profiler on the
H100 now and then misses device activities (the last one of a session,
or late in a long process all but those of the first calls), and a sum
over such a session reads low, so each session's kernels are counted
against the wrappers' launch counters (``LAUNCH_MARKERS``): a short
count runs the session again, up to PROFILE_TRIES times, then raises.
On ``--device cpu`` there is no card: the rows are the CPU ops' self
times, the output says so, and no idle share and no span's device ms
are given.

A span's device ms are the union of the device activities that the
host launched while the span was open (a kernel is matched to its
launch by the profiler's correlation id), whichever thread launched them:
autograd's device thread launches the backward's kernels while the main
thread waits inside ``mmt.step.backward``.
"""

from __future__ import annotations

import argparse
import bisect
import collections
import csv
import re
import sys
import time

import torch

from mmt_tpu_torch import bench

PROFILE_TRIES = 4

# The __global__ kernels of csrc/, by the source that defines them.
CUDA_FFN_KERNELS = ("ffn_block_bf16_kernel", "ffn_block_f32_kernel",
                    "ffn_cast_bf16_kernel", "ffn_ln_rows_kernel",
                    "ffn_tn_gemm_kernel", "ffn_sgemm_kernel",
                    "ffn_train_bwd_bf16_kernel", "ffn_train_bwd_f32_kernel",
                    "ffn_transpose_bf16_kernel", "ffn_ln_bwd_rows_kernel")
CUDA_SIM_KERNELS = ("moe_similarity_kernel", "fused_ranks_kernel",
                    "k_major_kernel")
# The grouped expert kernels of csrc/moe_grouped.cu (their names hold
# "gemm", which would file them as the library's).
CUDA_MOE_KERNELS = ("moe_grouped_gemm_kernel", "moe_grouped_wgrad_kernel",
                    "moe_grouped_combine_kernel")
# (category, pattern), the first that matches a name files it.
CATEGORIES = (
    ("cuda ffn (B1-B3, B6, B7)", re.compile("|".join(CUDA_FFN_KERNELS))),
    ("cuda similarity/rank (B4, B5)",
     re.compile("|".join(CUDA_SIM_KERNELS))),
    ("cuda moe experts", re.compile("|".join(CUDA_MOE_KERNELS))),
    ("library matmul", re.compile(
        r"gemm|gemv|cutlass|cublas|nvjet|xmma|splitKreduce"
        r"|aten::(?:mm|bmm|addmm|baddbmm|matmul|linear|_int_mm)\b", re.I)),
    ("copy", re.compile(r"memcpy|memset|direct_copy|copy_kernel"
                        r"|aten::(?:copy_|_to_copy|to)\b", re.I)),
    ("data formatting", re.compile(
        r"CatArray|aten::(?:cat|stack)\b|transpose|permute|index|gather"
        r"|scatter|pad", re.I)),
)
OTHER = "other"
# The CUDA runtime and driver calls among the host events: a launch
# carries the correlation id of the device activity it started.
_RUNTIME = re.compile(r"cuda[A-Z]|cu[A-Z]")

# The kernel each wrapper runs exactly once a launch, on each of its
# routes (csrc/): B1 and B2 end in their residual GEMM on the bf16 GEMM
# route (ffn_tn_gemm_kernel) and on the fp32 route (ffn_sgemm_kernel)
# (ffn_block.cu:launch_route, launch_f32_route), and are one WMMA / FMA
# kernel of their Mode off them; B3 starts both its routes with one
# LayerNorm-backward row pass (ffn_train_bwd.cu:launch_bwd_route,
# launch_bwd_f32_route); B4 and B5 are one kernel each (their k-major
# copies are shared).  B6 and B7 run only under tensor parallelism, which
# the benchmark's programs do not use.
_GEMMS = r"ffn_(?:tn_gemm|sgemm)_kernel<[^>]*"
LAUNCH_MARKERS = {
    "B1": re.compile(_GEMMS + r"(?<![A-Za-z])ResidualEpilogue>"
                     r"|ffn_block_(?:bf16|f32)_kernel<.*(?:Mode\)0|kEval)>"),
    "B2": re.compile(_GEMMS + r"DropResidualEpilogue>"
                     r"|ffn_block_(?:bf16|f32)_kernel<.*(?:Mode\)1|kTrain)>"),
    "B3": re.compile(r"ffn_ln_bwd_rows_kernel|ffn_train_bwd_(?:bf16|f32)_"),
    "B4": re.compile(r"moe_similarity_kernel"),
    "B5": re.compile(r"fused_ranks_kernel"),
}


def launch_counters():
  """{family: the wrapper whose ``launches`` counts its kernel's
  launches}, looked up when called."""
  from mmt_tpu_torch.ops import ffn, ranking, similarity
  return {"B1": ffn.ffn_block_cuda, "B2": ffn.ffn_train_fwd_cuda,
          "B3": ffn.ffn_train_bwd_cuda, "B4": similarity.sim_cuda,
          "B5": ranking.fused_counts_cuda}


def device_events(prof):
  """The device activities (kernels and copies) of a torch.profiler run,
  by name, without the GPU user annotations (spans such as
  ``Optimizer.step#Adam.step`` that enclose kernels counted already), as
  torch.profiler's own tables count device time."""
  from torch.autograd import DeviceType

  return [e for e in prof.key_averages()
          if e.device_type == DeviceType.CUDA and not e.is_user_annotation]


def short_kernel_name(key):
  """A device kernel's name without its return type, namespaces and
  parameter list: ``ffn_tn_gemm_kernel<64, GeluInterEpilogue>``."""
  for junk in ("void ", "(anonymous namespace)::", "mmt_gemm::",
               "mmt_sgemm::"):
    key = key.replace(junk, "")
  return key.split("(")[0]


def category(name):
  """The rollup category of a device activity or CPU op ``name``."""
  return next((label for label, pat in CATEGORIES if pat.search(name)),
              OTHER)


def recorded_launches(events):
  """{family: the launches its marker kernels record in ``events``}."""
  return {f: sum(e.count for e in events if pat.search(e.key))
          for f, pat in LAUNCH_MARKERS.items()}


def traced(run, device):
  """One torch.profiler session around ``run()``, the device synchronised
  at its end: (the profiler, wall ms)."""
  from torch.profiler import ProfilerActivity, profile

  cuda = torch.device(device).type == "cuda"
  activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda
                                         else [])
  bench.sync(device)
  with profile(activities=activities) as prof:
    tic = time.perf_counter()
    run()
    bench.sync(device)
    wall_ms = (time.perf_counter() - tic) * 1e3
  return prof, wall_ms


def session(run, device):
  """``traced(run, device)`` until every family's kernels recorded as
  many launches as its counter moved: (profiler, its device events,
  wall ms, launches).  A
  short count runs the session again, up to PROFILE_TRIES sessions, then
  raises; a count above the counter raises at once (a marker that does
  not mark one launch)."""
  counters = launch_counters()
  for _ in range(PROFILE_TRIES):
    before = {f: c.launches for f, c in counters.items()}
    prof, wall_ms = traced(run, device)
    launched = {f: c.launches - before[f] for f, c in counters.items()}
    events = device_events(prof)
    recorded = recorded_launches(events)
    if recorded == launched:
      return prof, events, wall_ms, launched
    if any(recorded[f] > launched[f] for f in launched):
      raise RuntimeError(f"the profiler recorded more launches than the "
                         f"counters moved: {recorded} against {launched}")
    print(f"profiler session recorded fewer launches than the counters "
          f"moved ({recorded} against {launched}): run again",
          file=sys.stderr, flush=True)
  raise RuntimeError(f"the profiler missed launches in {PROFILE_TRIES} "
                     "sessions")


def merged(intervals):
  """Sorted, disjoint [start, end] covering [(start, end)] intervals."""
  out = []
  for s, e in sorted(intervals):
    if out and s <= out[-1][1]:
      out[-1][1] = max(out[-1][1], e)
    else:
      out.append([s, e])
  return out


def union_us(intervals):
  """Microseconds of the union of [(start, end)] intervals."""
  return sum(e - s for s, e in merged(intervals))


def span_rollup(prof, device, runs):
  """{span: {"host_ms", "device_ms"}} a run, for each of the program's
  ``mmt.*`` spans the session recorded: the host ms of its events and,
  on the card, the device ms of the union of the device activities
  launched inside them (None on the CPU)."""
  from torch.autograd import DeviceType

  spans = collections.defaultdict(list)
  launched_at, ops = {}, []
  for e in prof.events():
    if e.device_type == DeviceType.CPU:
      if e.name.startswith("mmt."):
        spans[e.name].append((e.time_range.start, e.time_range.end))
      elif _RUNTIME.match(e.name):
        launched_at[e.id] = e.time_range.start
    elif not e.is_user_annotation:
      ops.append(e)
  cuda = torch.device(device).type == "cuda"
  # A device activity shares its correlation id with its launch.
  ops = [(launched_at[e.id], e.time_range.start, e.time_range.end)
         for e in ops if e.id in launched_at]
  out = {}
  for name, ivs in sorted(spans.items()):
    dev = None
    if cuda:
      open_ = merged(ivs)
      starts = [lo for lo, _ in open_]

      def launched_inside(t):
        k = bisect.bisect_right(starts, t) - 1
        return k >= 0 and t <= open_[k][1]

      dev = union_us([(s, e) for t, s, e in ops
                      if launched_inside(t)]) / 1e3 / runs
    out[name] = {"host_ms": sum(e - s for s, e in ivs) / 1e3 / runs,
                 "device_ms": dev}
  return out


def busy_us(prof):
  """Microseconds of the union of the device activities' intervals."""
  from torch.autograd import DeviceType

  return union_us([(e.time_range.start, e.time_range.end)
                   for e in prof.events() if e.device_type == DeviceType.CUDA
                   and not e.is_user_annotation])


def breakdown(prof, events, device, runs):
  """(rows, rollup, total ms per run) of a session of ``runs`` runs: on
  the card its device ``events`` (``session``'s) by self device time, on
  the CPU its CPU ops by self CPU time; each row's ms, share and
  occurrences per run, its short and full name and category."""
  from torch.autograd import DeviceType

  if torch.device(device).type == "cuda":
    self_us = lambda e: e.self_device_time_total
  else:
    # The ops, not the program's spans (``span_rollup`` reports those).
    events = [e for e in prof.key_averages()
              if e.device_type == DeviceType.CPU and not e.is_user_annotation]
    self_us = lambda e: e.self_cpu_time_total
  total_us = sum(map(self_us, events))
  rows = sorted(({"name": short_kernel_name(e.key), "key": e.key,
                  "category": category(e.key),
                  "ms_per_run": self_us(e) / 1e3 / runs,
                  "share": self_us(e) / total_us if total_us else 0.0,
                  "per_run": e.count / runs} for e in events),
                key=lambda r: -r["ms_per_run"])
  rollup = collections.Counter()
  for r in rows:
    rollup[r["category"]] += r["ms_per_run"]
  return rows, dict(rollup.most_common()), total_us / 1e3 / runs


def program(mode, reps, steps, device, tiny, cfg):
  """(the traced work, the number of runs it makes) of ``mode`` under
  bench's settings ``cfg``, built and warmed up outside the trace."""
  if mode == "eval":
    run_eval = bench.build_full_eval(
        device, tiny=tiny, videos=cfg["videos"], chunk=cfg["chunk"],
        compute_dtype=bench.DTYPES[cfg["dtype"]])
    run_eval()

    def run():
      for _ in range(reps):
        run_eval()

    return run, reps
  if mode == "train":
    one = bench.train_stepper(device, tiny=tiny,
                              batch_size=cfg["train_batch"],
                              opt=cfg["train_opt"])[2]
    for _ in range(2):
      float(one())

    def run():
      for _ in range(steps):
        loss = one()
      float(loss)

    return run, steps
  raise ValueError(f"unknown mode {mode!r}: eval or train")


def profile(mode="eval", reps=3, device="cuda", tiny=False, logdir=None,
            steps=None):
  """The breakdown of ``mode``'s program on ``device`` (``reps`` evals or
  ``steps`` train steps traced, bench.TRAIN_STEPS by default): {"mode",
  "runs",
  "device", "rows", "rollup", "spans", "wall_ms", "device_ms", "busy_ms",
  "idle", "launches", "trace"}; ms and launches are per run.  On the CPU
  "device_ms" is the CPU ops' self time and "busy_ms" and "idle" are
  None."""
  from mmt_tpu_torch.train.trainer import check_device
  from mmt_tpu_torch.utils.timing import export_trace

  device = check_device(device)
  if device.type == "cuda":
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
  cfg = bench.settings()
  with bench.kernel_path(device, cfg["plain"]):
    run, runs = program(mode, reps, steps or bench.TRAIN_STEPS, device,
                        tiny, cfg)
    prof, events, wall_ms, launched = session(run, device)
  rows, rollup, total_ms = breakdown(prof, events, device, runs)
  spans = span_rollup(prof, device, runs)
  busy_ms = busy_us(prof) / 1e3 / runs if device.type == "cuda" else None
  trace = None if logdir is None else str(export_trace(prof, logdir))
  wall_ms /= runs
  return {"mode": mode, "runs": runs, "device": device.type, "rows": rows,
          "rollup": rollup, "spans": spans, "wall_ms": wall_ms,
          "device_ms": total_ms, "busy_ms": busy_ms,
          "idle": None if busy_ms is None else 1 - busy_ms / wall_ms,
          "launches": {f: n / runs for f, n in launched.items()},
          "trace": trace}


def write_csv(rows, path):
  with open(path, "w", newline="") as fh:
    w = csv.writer(fh)
    w.writerow(["name", "category", "ms_per_run", "share", "per_run", "key"])
    for r in rows:
      w.writerow([r["name"], r["category"], r["ms_per_run"], r["share"],
                  r["per_run"], r["key"]])


def report(res, top, card):
  """The printed breakdown, as scripts/profile_eval.py prints it."""
  what = ("device self time" if res["device"] == "cuda" else
          "CPU ops' self time (a CPU run: no card, no device time)")
  total, runs = res["device_ms"], res["runs"]
  print(f"\n== {res['mode']} profile: {what} {total * runs:.3f} ms total / "
        f"{runs} program runs = {total:.3f} ms per run ==")
  print(f"{'self ms/run':>12}  {'%':>5}  {'occ/run':>7}  op")
  for r in res["rows"][:top]:
    print(f"{r['ms_per_run']:12.3f}  {100 * r['share']:5.1f}  "
          f"{r['per_run']:7g}  {r['name'][:90]}")
  print("\n== category rollup ==")
  for cat, ms in res["rollup"].items():
    print(f"{ms:12.3f}  {100 * ms / total if total else 0:5.1f}  {cat}")
  print("\n== program spans (ms a run) ==")
  print(f"{'host ms':>12}  {'device ms':>12}  span")
  for name, t in res["spans"].items():
    dev = ("not measured" if t["device_ms"] is None
           else f"{t['device_ms']:12.3f}")
    print(f"{t['host_ms']:12.3f}  {dev:>12}  {name}")
  idle = ("not measured (a CPU run)" if res["idle"] is None
          else f"{res['idle']:.4f} (device busy {res['busy_ms']:.3f} ms a "
          "run)")
  print(f"\nwall of the traced runs {res['wall_ms'] * runs:.3f} ms "
        f"({res['wall_ms']:.3f} per run); device idle share {idle}; "
        f"launches per run {res['launches']}; card: {card}")
  print(f"(raw trace: {res['trace'] or 'not kept; --logdir DIR keeps it'})")


def main(argv=None):
  ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
  ap.add_argument("--mode", default="eval", choices=["eval", "train"])
  ap.add_argument("--reps", type=int, default=3,
                  help="eval repetitions inside the trace")
  ap.add_argument("--steps", type=int, default=None,
                  help="train steps inside the trace (default: bench's 20)")
  ap.add_argument("--top", type=int, default=25, help="rows to print")
  ap.add_argument("--csv", default=None,
                  help="also write every row to this path")
  ap.add_argument("--logdir", default=None,
                  help="keep the trace here as a Chrome trace")
  ap.add_argument("--device", default="cuda",
                  help="torch device (default: the card)")
  ap.add_argument("--tiny", action="store_true",
                  help="the flagship's test-width copy")
  args = ap.parse_args(argv)
  res = profile(args.mode, args.reps, args.device, args.tiny, args.logdir,
                args.steps)
  if args.csv:
    write_csv(res["rows"], args.csv)
  card = bench.card_line() if res["device"] == "cuda" else None
  report(res, args.top, card)
  return res


if __name__ == "__main__":
  main()
