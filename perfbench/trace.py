"""A torch.profiler slice of the timed path, reduced to what the per-layer
metrics read: device operations with their intervals, device-side
annotations, host ops, the busy union, idle gaps and rollups by category.

The categories and the launch markers are copied from the program's
``mmt_tpu_torch/profile_eval.py``.  torch.profiler on the H100 now and
then misses device activities, so every slice is held to the kernel
wrappers' launch counters: a slice whose markers count fewer launches
than the counters moved is recorded again, up to TRIES times, then the
run fails.
"""

from __future__ import annotations

import collections
import re
import sys

import torch

TRIES = 4
SPAN = "perfbench.slice"

# The __global__ kernels of the program's csrc/, by the source that
# defines them (profile_eval.CUDA_FFN_KERNELS / CUDA_SIM_KERNELS).
CUDA_FFN_KERNELS = ("ffn_block_bf16_kernel", "ffn_block_f32_kernel",
                    "ffn_cast_bf16_kernel", "ffn_ln_rows_kernel",
                    "ffn_tn_gemm_kernel", "ffn_sgemm_kernel",
                    "ffn_train_bwd_bf16_kernel", "ffn_train_bwd_f32_kernel",
                    "ffn_transpose_bf16_kernel", "ffn_ln_bwd_rows_kernel")
CUDA_SIM_KERNELS = ("moe_similarity_kernel", "fused_ranks_kernel",
                    "k_major_kernel")
FFN, SIM, MATMUL = ("cuda ffn (B1-B3, B6, B7)",
                    "cuda similarity/rank (B4, B5)", "library matmul")
# (category, pattern): the first that matches a name files it.
CATEGORIES = (
    (FFN, re.compile("|".join(CUDA_FFN_KERNELS))),
    (SIM, re.compile("|".join(CUDA_SIM_KERNELS))),
    (MATMUL, re.compile(
        r"gemm|gemv|cutlass|cublas|nvjet|xmma|splitKreduce"
        r"|aten::(?:mm|bmm|addmm|baddbmm|matmul|linear|_int_mm)\b", re.I)),
    ("copy", re.compile(r"memcpy|memset|direct_copy|copy_kernel"
                        r"|aten::(?:copy_|_to_copy|to)\b", re.I)),
    ("data formatting", re.compile(
        r"CatArray|aten::(?:cat|stack)\b|transpose|permute|index|gather"
        r"|scatter|pad", re.I)),
)
OTHER = "other"
# The CUDA runtime and driver calls among the host events.
_RUNTIME = re.compile(r"cuda[A-Z]|cu[A-Z]")

# The kernel each wrapper runs exactly once a launch
# (profile_eval.LAUNCH_MARKERS).
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


def category(name):
  return next((label for label, pat in CATEGORIES if pat.search(name)),
              OTHER)


def short_name(name):
  """A kernel's name without its return type, namespaces and
  parameters."""
  for junk in ("void ", "(anonymous namespace)::", "mmt_gemm::",
               "mmt_sgemm::"):
    name = name.replace(junk, "")
  return name.split("(")[0][:120]


class Slice:
  """One profiled slice: ``ops`` [(name, start_s, end_s)] of the device
  activities (kernels, copies, sets), ``annotations`` the device-side
  user annotations, ``host`` the host ops, all on the profiler's clock,
  and ``span`` the (start, end) of the slice on the host."""

  def __init__(self, prof):
    from torch.autograd import DeviceType

    self.ops, self.annotations, self.host = [], [], []
    self.span = None
    for e in prof.events():
      iv = (e.name, e.time_range.start / 1e6, e.time_range.end / 1e6)
      annotation = getattr(e, "is_user_annotation", False)
      if e.device_type == DeviceType.CUDA:
        (self.annotations if annotation else self.ops).append(iv)
      elif e.device_type == DeviceType.CPU:
        if e.name == SPAN and self.span is None:
          self.span = iv[1:]
        elif not _RUNTIME.match(e.name):
          self.host.append(iv)
    if self.span is None:
      raise RuntimeError(f"the profiler recorded no {SPAN!r} span")

  @property
  def window_s(self):
    return self.span[1] - self.span[0]

  def busy(self):
    """Merged [(start, end)] of device activity inside the span."""
    lo, hi = self.span
    merged = []
    for _, s, e in sorted(self.ops, key=lambda o: o[1]):
      s, e = max(s, lo), min(e, hi)
      if e <= s:
        continue
      if merged and s <= merged[-1][1]:
        merged[-1][1] = max(merged[-1][1], e)
      else:
        merged.append([s, e])
    return merged

  def busy_s(self):
    return sum(e - s for s, e in self.busy())

  def by_category(self):
    """{category: device seconds} (each op's own duration)."""
    out = collections.Counter()
    for name, s, e in self.ops:
      out[category(name)] += e - s
    return out

  def inside(self, prefix):
    """Device seconds of the union of ops that lie inside a device-side
    annotation whose name starts with ``prefix``; None if there is no
    such annotation."""
    spans = [(s, e) for n, s, e in self.annotations if n.startswith(prefix)]
    if not spans:
      return None
    total = 0.0
    for lo, hi in spans:
      ops = [(max(s, lo), min(e, hi)) for _, s, e in self.ops]
      ops = sorted((s, e) for s, e in ops if e > s)
      end = lo
      for s, e in ops:
        s = max(s, end)
        if e > s:
          total += e - s
          end = e
    return total

  def host_op_at(self, t):
    """The innermost host op running at time ``t`` (latest start)."""
    best = None
    for name, s, e in self.host:
      if s <= t < e and (best is None or s > best[1]):
        best = (name, s)
    return best[0] if best else "no host op"

  def breakdown(self, top=10):
    """{"device_ops": [[name, seconds]], "idle_gaps": [[host op,
    seconds]]}: the device operations that took most time in all, and the
    longest idle gaps by the host op running as each began."""
    per_op = collections.Counter()
    for name, s, e in self.ops:
      per_op[short_name(name)] += e - s
    busy = self.busy()
    edges = [self.span[0]] + [x for iv in busy for x in iv] + [self.span[1]]
    gaps = [(edges[i], edges[i + 1]) for i in range(0, len(edges), 2)
            if edges[i + 1] > edges[i]]
    gaps.sort(key=lambda g: g[0] - g[1])
    return {"device_ops": [[n, s] for n, s in per_op.most_common(top)],
            "idle_gaps": [[self.host_op_at(s), e - s]
                          for s, e in gaps[:top]]}


def recorded_launches(slice_):
  return {f: sum(1 for n, _, _ in slice_.ops if pat.search(n))
          for f, pat in LAUNCH_MARKERS.items()}


def record(run, counters, device):
  """Profile ``run()`` inside a SPAN annotation that ends in a
  synchronise, until every family's markers count as many launches as its
  counter moved.  ``counters``: {family: object with ``launches``}.
  Returns the Slice."""
  from torch.profiler import ProfilerActivity, profile, record_function

  cuda = torch.device(device).type == "cuda"
  activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda
                                         else [])
  for _ in range(TRIES):
    before = {f: c.launches for f, c in counters.items()}
    if cuda:
      torch.cuda.synchronize(device)
    with profile(activities=activities) as prof:
      with record_function(SPAN):
        run()
        if cuda:
          torch.cuda.synchronize(device)
    launched = {f: c.launches - before[f] for f, c in counters.items()}
    slice_ = Slice(prof)
    recorded = recorded_launches(slice_)
    if recorded == launched:
      return slice_
    if any(recorded[f] > launched[f] for f in launched):
      raise RuntimeError(f"the profiler recorded more launches than the "
                         f"counters moved: {recorded} against {launched}")
    print(f"profiler slice recorded {recorded} launches against {launched}"
          f" counted: recording again", file=sys.stderr, flush=True)
  raise RuntimeError(f"the profiler missed launches in {TRIES} slices")
