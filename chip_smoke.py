#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (mmt_tpu_torch) once on one NVIDIA GPU.

  python3 chip_smoke.py          # from the repository root, one card

Phases, each of which raises (exit code 1, no final line) on failure:

1. Build the CUDA kernels from mmt_tpu_torch/csrc/ with nvcc (sm_90a),
   one nvcc process per source, all at once.
2. Kernel phase: each eval kernel against its plain PyTorch version on
   the card, at the flagship eval shapes (FFN block: video 10,900 x 512
   and text 1,500 x 768 rows with I = 3072, bf16 and fp32, plus a ragged
   row count, and in bf16 a width off the GEMM route, 1,013 x 192 with
   I = 768, which keeps the WMMA kernel; similarity: 1000 x 1000 with
   M = 7, D = 512, plus a ragged
   37 x 53 case with all-zero weight rows), with the max abs error and
   both times.  Tolerances: FFN fp32 atol 1e-4; FFN bf16 atol 3e-2 and
   mean abs error <= 2e-3; similarity atol 1e-5.  The bf16 FFN block
   takes the TMA + wgmma GEMM route at these widths: its device time
   under torch.profiler (``device_ms``: the event time of a call under
   ~0.1 ms is the host's) and achieved TFLOP/s,
   the time of its two bf16 ``torch.mm`` products alone (``gemms_ms``, a
   yardstick that does less work), its wrapper's host time a call
   (``host_ms``), every row tile of the route bitwise equal at the video
   and text shapes, and at the video shape the block under autograd
   (kernel forward, the vjp of ``ffn_block_ref``, the XLA reference's
   numerics) against the exact fp64 gradients: each within 2e-2 relative
   L2 (plain autograd's printed beside it).  The similarity also
   through every tile shape it is built for, whose outputs must be
   bitwise equal (and an unknown tile id refused); with K = 3,586 (no
   multiple of 4 or of the slice depth) at 1e-5; and timed at the train
   step's 32 x 32.
3. Rank-kernel phase: the fused similarity-and-rank kernel (B5) against
   its plain version, each case in the t2v and the v2t orientation: (a)
   50,000 x 50,000 unit-norm random embeddings (M = 7, D = 512) with
   all-zero weight rows; (b) 2,000 captions x 1,000 videos with masked
   caption slots, one video with every slot masked and 24 padding
   videos; (c) exact arithmetic with duplicated rows.  Tolerance: the
   same inf positions, every rank within 1, and where there are at least
   10,000 queries on fewer than 1e-3 of them; per call, every query's
   counts may differ only by candidates whose fp64 similarity lies within
   twice the fp32 sum-order noise of the GT (check_counts_witness); (c)
   equal counts with a tie counted.  In (b) and (c)
   the counts must also equal, as integers and in every tile shape, the
   counts taken from the similarity kernel's own matrix (B5 compares
   bitwise B4's values); and one call with K = 3,586 against both.
   Kernel, plain and fp32 torch.mm (numerator only) times and the bound
   of each.
4. Train-kernel phase: the FFN train forward (B2) and backward (B3,
   add_dz on and off) against their plain versions at the b32 train
   shapes (video 6,976 x 512, text 960 x 768, ragged 1,013 x 768, I =
   3072), bf16 and fp32, masks at p = 0.1 from a seeded generator.
   Tolerances: fp32 atol 1e-4 on every output; bf16 fp32 outputs max 3e-2
   and mean 2e-3; bf16 compute-dtype outputs within 2 bf16 ulps of the
   plain version's (the ulp of the larger of the two magnitudes) plus an
   absolute floor for values near zero (CD_ATOL below).  In bf16 these
   widths take the TMA + wgmma GEMM route: its outputs also against the
   WMMA kernel's (``tile=-1``) by the same rules, every row tile bitwise
   equal, and beside the event and plain times its ``device_ms``, the
   WMMA kernel's event and device times, ``host_ms`` and ``gemms_ms``.
5. Reference phase: a tiny fp32 CENet on the card (kernels) against the
   same weights on the CPU (plain versions), sims atol 1e-4.
6. Slice phase (then a profile phase): the full-width flagship CENet
   (bf16, random weights from
   a seed, ``bench.staged_flagship``) embeds 1000 captions and 1000 videos
   in 20 chunks of 50, builds the 1k x 1k similarity and ranks it.  The
   launch counters must read exactly 16 x 20 = 320 FFN launches and at
   least one similarity launch; every output must be finite; the same
   eval with the plain versions must give sims within 2e-2.  Then the
   eval's wall time on both paths, median of 5 runs after a warm-up,
   taken in turns.  The profile phase runs the eval once more on the
   kernel path under torch.profiler: device time, wall, the top device
   operations, B1's kernels in situ against their kernel-phase time alone
   times the launches, the device activities launched, and the device's
   idle share of the wall.
7. At-scale phase: the same model and videos through bench.py's
   streaming protocol at 20,000 videos (20 salted passes of 1000 in
   chunks of 50) and the fused eval (``retrieval_eval(fused=True)``, no
   [Q, V] matrix).  Exactly 16 x 400 = 6,400 FFN, 0 similarity and 2 rank
   kernel launches; finite metrics; on the same embeddings the kernel
   path's ranks against the plain path's (the rule of phase 3) and
   against the matrix path's (B4 and the matrix ranks), which may differ
   only by the candidates that lie between the two paths' GT values (the
   fused path computes the GT similarity directly); the peak device
   memory of both rankings; B5's time at 20k; the fused eval's wall time
   on both paths, median of 3 after a warm-up, taken in turns.
8. Train-step phase: the full-width flagship in bf16, b32, Adam (lr
   5e-5) on the max-margin loss (margin 0.05, fix_norm).  One step must
   launch exactly 16 B2, 16 B3, >= 1 similarity and 0 eval FFN kernels;
   from the same state and generator seed the plain path's loss and
   gradients must agree (loss within 1e-4 absolute, all gradients
   within 2e-2 relative L2, every parameter's within 0.2, see STEP_*_TOL
   below); 20 steps on one batch must give finite losses and move the
   BatchNorm running statistics.  Then the step time on both paths, b32
   and b128, median of 20 after 3 warm-ups, taken in turns.  The train
   profile phase then runs 3 kernel-path steps at b32 and at b128 under
   torch.profiler: device time, the device's idle share of the wall, the
   device activities, B2's and B3's kernels in situ (exactly 16 launches
   of each a step) against their device time alone times the launches,
   and the top device operations.
9. Partial-kernel phase: the tensor-parallel halves B6 (eval, video
   10,900 x 512 and text 1,500 x 768 rows, and 1,013 x 192 off the GEMM
   route) and B7 (train forward, video
   6,976 x 512 and text 960 x 768 rows), each also at a ragged 1,013 x
   768, and B3 with add_dz off on B7's residuals, all at I/mp = 1536,
   bf16 and fp32, against their plain versions (B6, B7 and B3 in bf16
   also with their device time, B6's and B7's also by kernel, and, at
   the video and text shapes, every
   row tile bitwise equal, as phases 2 and 4; B6 with ``gemms_ms``).  On
   the GEMM route B7 and B3 also against their WMMA kernels
   (``tile=-1``, the same rules; their event and device times), B7 with
   ``host_ms``, and B7's partial bitwise equal to B6's on the same
   inputs in every row tile.  A
   partial is not normalised, so the rules of phase 4 hold on its fp32
   outputs divided by the plain version's largest magnitude; the
   compute-dtype outputs keep phase 4's ulp rule.
10. Tensor-parallel phase: ``parallel.spawn`` starts two ranks that
   share the card over gloo (NCCL refuses two ranks on one device).
   Each builds the flagship from the same seed and keeps its shards.
   The 1k x 1k eval of phase 6: exactly 320 B6 and 0 B1 launches per
   rank, both ranks' sims bitwise equal, within TP_SIMS_TOL (5e-3) of
   phase 6's kernel path, and its ranks against phase 6's
   (check_tp_ranks).  The b32 step
   of phase 8 from its state, batch and dropout seed: exactly 16 B7, 16
   B3 and 0 B1/B2/B6 launches per rank, the loss and the gathered
   gradients within phase 8's tolerances of its kernel step; after 3
   steps every replicated parameter and buffer bitwise equal on both
   ranks.  Wall times are of two gloo ranks sharing one card: a
   correctness path, no claim of speed.  A failing rank fails the run.

Each phase prints its seconds, and the run its total.  The last two
lines of stdout are one JSON object of kernel results (each kernel's
launches on its main path, worst disagreement, times, bound and library
time) and {"ok": true, "device": {...}}; the card's name and power limit
come on the line before them.
"""

from __future__ import annotations

import contextlib
import json
import statistics
import subprocess
import sys
import time

N_VIDEOS, CHUNK = 1000, 50
FFN_LAYERS = 12 + 4     # text + video tower layers, one FFN block each


def time_ms(torch, fn, reps=20):
  """Mean device time of one call, from CUDA events around ``reps``
  calls after one warm-up call."""
  fn()
  torch.cuda.synchronize()
  start = torch.cuda.Event(enable_timing=True)
  end = torch.cuda.Event(enable_timing=True)
  start.record()
  for _ in range(reps):
    fn()
  end.record()
  torch.cuda.synchronize()
  return start.elapsed_time(end) / reps


def device_events(prof):
  """The device activities (kernels and copies) of a torch.profiler run,
  by name, without the GPU user annotations (spans such as
  ``Optimizer.step#Adam.step`` that enclose kernels counted already), as
  torch.profiler's own tables count device time."""
  from torch.autograd import DeviceType

  return [e for e in prof.key_averages()
          if e.device_type == DeviceType.CUDA and not e.is_user_annotation]


def device_split(torch, fn, reps=20):
  """{device activity: mean device ms of it in one call} under
  torch.profiler over ``reps`` calls after a warm-up."""
  from torch.profiler import ProfilerActivity, profile

  fn()
  torch.cuda.synchronize()
  with profile(activities=[ProfilerActivity.CPU,
                           ProfilerActivity.CUDA]) as prof:
    for _ in range(reps):
      fn()
    torch.cuda.synchronize()
  return {e.key: e.self_device_time_total / 1e3 / reps
          for e in device_events(prof)}


def device_ms(torch, fn, reps=20):
  """Mean device time of one call: its kernels' own time under
  torch.profiler over ``reps`` calls after a warm-up.  Unlike
  ``time_ms`` it leaves out the gaps in which the device waits for the
  host, which set the event time of calls that take under ~0.1 ms."""
  return sum(device_split(torch, fn, reps).values())


def short_kernel_name(key):
  """A device kernel's name without its return type, namespaces and
  parameter list: ``ffn_tn_gemm_kernel<64, GeluInterEpilogue>``."""
  for junk in ("void ", "(anonymous namespace)::", "mmt_gemm::"):
    key = key.replace(junk, "")
  return key.split("(")[0]


class CardSampler:
  """While open, nvidia-smi samples the card's SM clock (MHz) and power
  draw (W) every 20 ms; ``summary()`` after.  The card lowers its clock
  under load when it reaches its power limit, which a kernel timed alone
  for a few milliseconds does not show."""

  def __enter__(self):
    self.proc = subprocess.Popen(
        ["nvidia-smi", "--query-gpu=clocks.sm,power.draw",
         "--format=csv,noheader,nounits", "-lms", "20"],
        stdout=subprocess.PIPE, stderr=subprocess.DEVNULL, text=True)
    return self

  def __exit__(self, *exc):
    self.proc.terminate()
    out = self.proc.communicate(timeout=30)[0]
    self.samples = []
    for line in out.splitlines():
      try:
        clock, power = (float(v) for v in line.split(","))
      except ValueError:
        continue
      self.samples.append((clock, power))

  def summary(self):
    if not self.samples:
      return "SM clock and power draw: no samples"
    clocks, powers = zip(*self.samples)
    return (f"SM clock median {statistics.median(clocks):.0f} MHz (min "
            f"{min(clocks):.0f}, max {max(clocks):.0f}), power draw median "
            f"{statistics.median(powers):.1f} W (max {max(powers):.1f}) over "
            f"{len(self.samples)} samples")


# Peaks of one H100 SXM at 700 W (NVIDIA's data sheet, dense): bf16 tensor
# cores, fp32 FMA outside the tensor cores, device memory.
H100_BF16, H100_FP32, H100_BYTES = 989e12, 67e12, 3.35e12


def bound(flops, rate, tensors):
  """(ms, what sets it): the least time of the work on the H100, the
  larger of its FLOPs at ``rate`` and its bytes (each tensor read or
  written once) at the memory rate."""
  nbytes = sum(t.numel() * t.element_size() for t in tensors)
  ops_ms, bytes_ms = flops / rate * 1e3, nbytes / H100_BYTES * 1e3
  return (ops_ms, "operations") if ops_ms >= bytes_ms else (bytes_ms,
                                                            "bytes")


def tflops(r, h, i, ms):
  """Achieved TFLOP/s of the block's two products (4 R H I FLOP)."""
  return 4 * r * h * i / ms / 1e9


def gemms_ms(torch, x, w1, w2):
  """Yardstick: the two bf16 ``torch.mm`` products of the block alone
  (no bias, GELU, residual or LayerNorm; the port never calls them)."""
  xb = x.to(torch.bfloat16)
  g = torch.randn(x.shape[0], w1.shape[0], device=x.device).to(
      torch.bfloat16)
  return time_ms(torch, lambda: (torch.mm(xb, w1.T), torch.mm(g, w2.T)))


def as_tuple(out):
  return out if isinstance(out, tuple) else (out,)


def check_tiles_equal(torch, ffn, what, kernel, args, kw):
  """Every row tile of the GEMM route gives the same bits (the same
  wgmma chain over K) in every output; prints each tile's time.  Raises
  otherwise."""
  outs = [as_tuple(kernel(*args, **kw, tile=t))
          for t in range(len(ffn.GEMM_TILES))]
  same = [all(map(torch.equal, outs[0], o)) for o in outs]
  by_tile = {rows: round(time_ms(torch, lambda t=t: kernel(*args, **kw,
                                                           tile=t)), 4)
             for t, rows in enumerate(ffn.GEMM_TILES)}
  print(f"  {what} row tiles {ffn.GEMM_TILES}: outputs bitwise equal {same};"
        f" kernel_ms by tile {by_tile}", flush=True)
  if not all(same):
    raise RuntimeError(f"{what}: a row tile changed the values")


# The eval block's gradients under autograd on the kernel path (the vjp of
# ffn_block_ref, the XLA reference's numerics: bias and GELU in bf16)
# against the exact gradient (fp64 autograd of the same math unrounded):
# each within 2e-2 relative L2, the train step's bf16 rule on all
# gradients (STEP_ALL_GRADS_TOL); measured ~5e-3 at 1,000 x 512 on a CPU.
FFN_GRAD_TOL = 2e-2
GRAD_NAMES = ("x", "w1", "b1", "w2", "b2", "gamma", "beta")


def ffn_grad_check(torch, ops, ffn, x, w1, b1, w2, b2, gamma, beta):
  """B1 under autograd at this shape: the kernel launches once, the
  output has a graph, and the gradients of x, the fp32 master weights,
  b1, b2, gamma and beta lie within FFN_GRAD_TOL of the exact ones.
  Prints plain autograd's (bf16, fp32 bias and GELU) beside them."""
  masters = (x, w1.float(), b1, w2.float(), b2, gamma, beta)
  dy = torch.randn(x.shape, device=x.device)

  def run(dtype, cd, plain):
    leaves = [t.detach().to(dtype).requires_grad_(True) for t in masters]
    xl, w1l, b1l, w2l, *rest = leaves
    with ops.plain_versions() if plain else contextlib.nullcontext():
      out = ffn.ffn_block(xl, w1l.to(cd), b1l, w2l.to(cd), *rest, eps=1e-12,
                          compute_dtype=cd)
      if out.grad_fn is None:
        raise RuntimeError("ffn_block under autograd returned no graph")
      return torch.autograd.grad((out * dy.to(dtype)).sum(), leaves)

  before = ffn.ffn_block_cuda.launches
  got = run(torch.float32, torch.bfloat16, False)
  if ffn.ffn_block_cuda.launches != before + 1:
    raise RuntimeError("ffn_block under autograd did not launch B1 once")
  exact = run(torch.float64, torch.float64, True)
  plain = run(torch.float32, torch.bfloat16, True)
  rel = lambda gs: {n: float((g.double() - e).norm() / e.norm())
                    for n, g, e in zip(GRAD_NAMES, gs, exact)}
  got_rel, plain_rel = rel(got), rel(plain)
  for what, r in (("kernel forward, ffn_block_ref's vjp", got_rel),
                  ("plain autograd, bf16", plain_rel)):
    print(f"  ffn_block under autograd ({what}) vs exact (fp64), gradients' "
          "relative L2: " + ", ".join(f"{n} {v:.3e}" for n, v in r.items()),
          flush=True)
  if not all(v <= FFN_GRAD_TOL for v in got_rel.values()):
    raise RuntimeError(f"ffn_block gradients outside {FFN_GRAD_TOL}: "
                       f"{got_rel}")


def host_ms(torch, fn, reps=50, rounds=5):
  """Host time of one call, as text: the median over ``rounds`` of the
  wall of queuing ``reps`` calls without waiting for the device (the
  queue is deep enough not to block), and the rounds' range (the host is
  shared, so one round can read half again as long as the next)."""
  fn()
  torch.cuda.synchronize()
  per_round = []
  for _ in range(rounds):
    tic = time.perf_counter()
    for _ in range(reps):
      fn()
    per_round.append((time.perf_counter() - tic) * 1e3 / reps)
    torch.cuda.synchronize()
  return (f"{statistics.median(per_round):.4f} (rounds {min(per_round):.4f}"
          f"-{max(per_round):.4f})")


def ffn_phase(torch, ops, ffn, dev, gen, card):
  """Each FFN case: kernel vs plain version; returns the kernel's line
  entries (the bf16 cases' worst error, and the video-shape bf16 times
  and bound: no single PyTorch call computes the block) and the bf16
  kernel time of each (rows, H)."""
  cases = [(10900, 512, 3072, torch.bfloat16), (1500, 768, 3072,
                                                torch.bfloat16),
           (1013, 768, 3072, torch.bfloat16),
           (1013, 192, 768, torch.bfloat16),   # off the GEMM route: WMMA
           (10900, 512, 3072, torch.float32), (1500, 768, 3072,
                                               torch.float32),
           (1013, 768, 3072, torch.float32)]
  res, alone = {"max_abs_err": 0.0, "library_ms": None}, {}
  for r, h, i, cd in cases:
    rand = lambda *s: torch.randn(*s, generator=gen, device=dev)
    x = rand(r, h)
    w1, w2 = (rand(i, h) * 0.02).to(cd), (rand(h, i) * 0.02).to(cd)
    b1, b2 = rand(i) * 0.02, rand(h) * 0.02
    gamma, beta = 1.0 + 0.1 * rand(h), 0.1 * rand(h)
    args = (x, w1, b1, w2, b2, gamma, beta)
    kw = dict(eps=1e-12, compute_dtype=cd)
    got = ffn.ffn_block_cuda(*args, **kw)
    want = ffn.ffn_block_plain(*args, **kw)
    torch.cuda.synchronize()
    err = (got - want).abs()
    max_err, mean_err = float(err.max()), float(err.mean())
    ms = time_ms(torch, lambda: ffn.ffn_block_cuda(*args, **kw))
    plain_ms = time_ms(torch, lambda: ffn.ffn_block_plain(*args, **kw))
    name = str(cd).replace("torch.", "")
    route = "gemm" if ffn.gemm_route(h, i, cd) else "wmma/fma"
    dev_ms = device_ms(torch, lambda: ffn.ffn_block_cuda(*args, **kw))
    print(f"ffn_block R={r} H={h} I={i} {name} ({route} route): max_abs_err="
          f"{max_err:.3e} mean_abs_err={mean_err:.3e} kernel_ms={ms:.4f} "
          f"({tflops(r, h, i, ms):.1f} TFLOP/s) device_ms={dev_ms:.4f} "
          f"({tflops(r, h, i, dev_ms):.1f} TFLOP/s) plain_ms={plain_ms:.4f}",
          flush=True)
    if not bool(torch.isfinite(got).all()):
      raise RuntimeError("ffn_block kernel produced non-finite values")
    if cd == torch.float32 and max_err > 1e-4:
      raise RuntimeError(f"ffn_block fp32 error {max_err} > 1e-4")
    if cd == torch.bfloat16:
      if max_err > 3e-2 or mean_err > 2e-3:
        raise RuntimeError(f"ffn_block bf16 error {max_err}/{mean_err} "
                           "exceeds 3e-2 (max) / 2e-3 (mean)")
      res["max_abs_err"] = max(res["max_abs_err"], max_err)
      alone[(r, h)] = (ms, dev_ms)
      b_ms, b_by = bound(4 * r * h * i, H100_BF16, args + (got,))
      yard_ms = gemms_ms(torch, x, w1, w2)
      print(f"  bound {b_ms:.4f} ms ({b_by}); gemms_ms={yard_ms:.4f} (two "
            f"bf16 torch.mm alone, a yardstick of less work) card: {card}",
            flush=True)
      if ffn.gemm_route(h, i, cd) and r != 1013:
        check_tiles_equal(torch, ffn, f"ffn_block R={r} H={h}",
                          ffn.ffn_block_cuda, args, kw)
        call_ms = host_ms(torch, lambda: ffn.ffn_block_cuda(*args, **kw))
        print(f"  host_ms={call_ms} (the wrapper's host time a call: "
              "checks, scratch, tensor maps, 4 launches)", flush=True)
      if (r, h) == (10900, 512):
        res.update(ms=ms, plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by)
        ffn_grad_check(torch, ops, ffn, *args)
  return res, alone


def sim_inputs(torch, q, v, m, d, dev, gen, zero_rows=False):
  """t [q, m * d], v [v, m * d] weight-scaled unit-norm rows and their
  weights tw [q, m], vw [v, m]."""
  te = torch.randn(q, m, d, generator=gen, device=dev)
  ve = torch.randn(v, m, d, generator=gen, device=dev)
  te, ve = te / te.norm(dim=-1, keepdim=True), ve / ve.norm(dim=-1,
                                                          keepdim=True)
  tw = torch.rand(q, m, generator=gen, device=dev)
  vw = torch.rand(v, m, generator=gen, device=dev)
  tw, vw = tw / tw.sum(-1, keepdim=True), vw / vw.sum(-1, keepdim=True)
  if zero_rows:
    tw[3] = 0.0
    vw[5] = 0.0
    vw[7] = 0.0
  return ((te * tw[:, :, None]).reshape(q, m * d),
          (ve * vw[:, :, None]).reshape(v, m * d), tw, vw)


def sim_phase(torch, similarity, dev, gen, card):
  """Similarity kernel vs plain version; returns the kernel's line
  entries: the worst error, and the 1000 x 1000 times, bound and
  library time (the fp32 ``torch.mm`` of the numerator alone, which
  computes less than the kernel)."""
  res = {"max_abs_err": 0.0}
  tiles = range(len(similarity.TILES))
  for q, v, m, d, zero_rows in ((1000, 1000, 7, 512, False),
                                (37, 53, 7, 512, True)):
    t, vv, tw, vw = sim_inputs(torch, q, v, m, d, dev, gen, zero_rows)
    got = similarity.sim_cuda(t, vv, tw, vw)
    want = similarity.sim_plain(t, vv, tw, vw)
    torch.cuda.synchronize()
    max_err = float((got - want).abs().max())
    ms = time_ms(torch, lambda: similarity.sim_cuda(t, vv, tw, vw))
    plain_ms = time_ms(torch, lambda: similarity.sim_plain(t, vv, tw, vw))
    print(f"moe_similarity Q={q} V={v} M={m} D={d}: max_abs_err="
          f"{max_err:.3e} kernel_ms={ms:.4f} plain_ms={plain_ms:.4f}",
          flush=True)
    if not bool(torch.isfinite(got).all()) or max_err > 1e-5:
      raise RuntimeError(f"moe_similarity error {max_err} > 1e-5")
    res["max_abs_err"] = max(res["max_abs_err"], max_err)
    # Every tile shape computes the same fmaf chains: the same bits.
    same = [torch.equal(got, similarity.sim_cuda(t, vv, tw, vw, tile=i))
            for i in tiles]
    by_tile = {f"{r}x{c}": round(time_ms(
        torch, lambda i=i: similarity.sim_cuda(t, vv, tw, vw, tile=i)), 4)
               for i, (r, c) in enumerate(similarity.TILES)}
    print(f"  tile shapes {similarity.TILES}: outputs bitwise equal {same}; "
          f"kernel_ms by tile {by_tile}", flush=True)
    if not all(same):
      raise RuntimeError("moe_similarity: a tile shape changed the values")
    if q == 1000:
      lib_ms = time_ms(torch, lambda: torch.mm(t, vv.T))
      b_ms, b_by = bound(2 * q * v * m * (d + 1), H100_FP32,
                         (t, vv, tw, vw, got))
      res.update(ms=ms, plain_ms=plain_ms, library_ms=lib_ms,
                 bound_ms=b_ms, bound_by=b_by)
      print(f"  library (torch.mm numerator) {lib_ms:.4f} ms; bound "
            f"{b_ms:.4f} ms ({b_by}) card: {card}", flush=True)
  try:
    similarity.sim_cuda(t, vv, tw, vw, tile=len(similarity.TILES))
  except RuntimeError as e:
    print(f"  unknown tile id refused: {e}", flush=True)
  else:
    raise RuntimeError("moe_similarity accepted an unknown tile id")

  # K = 3,586: no multiple of 4 or of the slice depth (the zero-filled tail).
  # These cases draw from a generator of their own: the phases after this
  # one keep the inputs they had before the cases were added.
  gen = torch.Generator(device=dev).manual_seed(2)
  t, vv, tw, vw = sim_inputs(torch, 130, 260, 2, 1793, dev, gen)
  want = similarity.sim_plain(t, vv, tw, vw)
  for i in tiles:
    err = float((similarity.sim_cuda(t, vv, tw, vw, tile=i) - want)
                .abs().max())
    print(f"moe_similarity Q=130 V=260 K={t.shape[1]} tile "
          f"{similarity.TILES[i]}: max_abs_err={err:.3e}", flush=True)
    if not err <= 1e-5:
      raise RuntimeError(f"moe_similarity K % 4 != 0 error {err} > 1e-5")
    res["max_abs_err"] = max(res["max_abs_err"], err)

  # The train step's shape: one block.
  t, vv, tw, vw = sim_inputs(torch, 32, 32, 7, 512, dev, gen)
  ms = time_ms(torch, lambda: similarity.sim_cuda(t, vv, tw, vw))
  plain_ms = time_ms(torch, lambda: similarity.sim_plain(t, vv, tw, vw))
  lib_ms = time_ms(torch, lambda: torch.mm(t, vv.T))
  b_ms, b_by = bound(2 * 32 * 32 * 7 * 513, H100_FP32,
                     (t, vv, tw, vw, similarity.sim_cuda(t, vv, tw, vw)))
  print(f"moe_similarity Q=32 V=32 M=7 D=512: kernel_ms={ms:.4f} plain_ms="
        f"{plain_ms:.4f} library_ms={lib_ms:.4f} bound_ms={b_ms:.6f} ({b_by}) "
        f"card: {card}", flush=True)
  return res


TRAIN_SHAPES = ((6976, 512), (960, 768), (1013, 768))   # b32 video, text
TRAIN_I, TRAIN_P = 3072, 0.1
# bf16 outputs in the compute dtype: within 2 bf16 ulps, plus an absolute
# floor for values near zero, where a small absolute difference is many
# ulps.  Before inter and dz are rounded, kernel and plain version differ
# only by fp32 sum order (tensor-core WMMA against cuBLAS, warp against
# torch reductions): 1e-5.  z and dinter come out of a second product
# whose operand (the GELU output, dffn) was rounded to bf16, and that
# sum-order noise flips such an operand by one ulp now and then; one flip
# moves a sum by ulp(operand) * |weight|, up to ~3e-3 here: 4e-3.
CD_ATOL = {"inter": 1e-5, "z": 4e-3, "dz": 1e-5, "dinter": 4e-3}


def bf16_ulp(torch, got, want):
  """Elementwise bf16 ulp at the larger of the two magnitudes."""
  ref = torch.maximum(got.float().abs(), want.float().abs())
  _, exp = torch.frexp(ref)
  return torch.ldexp(torch.ones_like(ref), exp - 8)


def check_outputs(torch, what, cd, got, want, cd_names):
  """Compare each named output with the plain version's; ``cd_names``
  are the compute-dtype outputs.  Returns the worst max abs error of the
  fp32 outputs.  Raises past the tolerance."""
  worst = 0.0
  for name in got:
    g, w = got[name], want[name]
    if not bool(torch.isfinite(g).all()):
      raise RuntimeError(f"{what}: non-finite {name}")
    err = (g.float() - w.float()).abs()
    max_err, mean_err = float(err.max()), float(err.mean())
    msg = f"{name} max_abs_err={max_err:.3e} mean_abs_err={mean_err:.3e}"
    if cd == torch.float32:
      bad = max_err > 1e-4
    elif name in cd_names:
      ulp = bf16_ulp(torch, g, w)
      over = err > 2 * ulp
      max_over = float(err[over].max()) if bool(over.any()) else 0.0
      msg += (f" max_ulps={float((err / ulp).max()):.2f} n_over_2ulps="
              f"{int(over.sum())} of {err.numel()} (largest abs diff among "
              f"them {max_over:.3e})")
      bad = bool((err > 2 * ulp + CD_ATOL[name]).any())
    else:
      bad = max_err > 3e-2 or mean_err > 2e-3
    print(f"  {what} {msg}", flush=True)
    if bad:
      raise RuntimeError(f"{what}: {name} outside its tolerance ({msg})")
    if name not in cd_names:
      worst = max(worst, max_err)
  return worst


def train_inputs(torch, dropout, r, h, cd, dev, gen):
  """B2's operands (x, drop, w1, b1, w2, b2, gamma, beta) at R x H with
  I = TRAIN_I and the cotangent dy [R, H], drawn from ``gen``."""
  i = TRAIN_I
  rand = lambda *s: torch.randn(*s, generator=gen, device=dev)
  x = rand(r, h)
  drop = dropout.dropout_mask((r, h), TRAIN_P, gen, dev)
  w1, w2 = (rand(i, h) * 0.02).to(cd), (rand(h, i) * 0.02).to(cd)
  b1, b2 = rand(i) * 0.02, rand(h) * 0.02
  gamma, beta = 1.0 + 0.1 * rand(h), 0.1 * rand(h)
  return (x, drop, w1, b1, w2, b2, gamma, beta), rand(r, h)


TRAIN_OUTS = {"ffn_train_fwd": (("out", "inter", "z"), ("inter", "z")),
              "ffn_train_bwd": (("dx", "dz", "dinter"), ("dz", "dinter"))}


def check_train_kernel(torch, ffn, what, kname, cd, args, kw, i=TRAIN_I,
                       check=check_outputs):
  """B2 or B3 (``kname``) on these operands (width I) against its plain
  version by ``check``'s rules and, on the GEMM route, against the WMMA
  kernel (``tile=-1``) by the same rules, with every row tile bitwise
  equal.  Returns the kernel's outputs and what ``check`` returns."""
  kernel, plain = (getattr(ffn, f"{kname}_cuda"),
                   getattr(ffn, f"{kname}_plain"))
  names, cd_names = TRAIN_OUTS[kname]
  got = kernel(*args, **kw)
  outs = lambda t: dict(zip(names, t))
  err = check(torch, f"{what} vs plain", cd, outs(got),
              outs(plain(*args, **kw)), cd_names)
  if ffn.gemm_route(args[0].shape[1], i, cd):
    check(torch, f"{what} vs WMMA kernel", cd, outs(got),
          outs(kernel(*args, **kw, tile=-1)), cd_names)
    check_tiles_equal(torch, ffn, what, kernel, args, kw)
  return got, err


def train_kernel_phase(torch, ffn, dropout, dev, gen, card):
  """B2 and B3 (add_dz on and off) against their plain versions at the
  b32 train shapes, and on the GEMM route (bf16) also against the WMMA
  kernel (``tile=-1``), timed against both.  Returns each kernel's line
  entries (the worst bf16 error, and the video bf16 times and bound: no
  single PyTorch call computes either) and the device ms of one bf16 call
  of each by shape, for the train profile."""
  res = {name: {"max_abs_err": 0.0, "library_ms": None}
         for name in ("ffn_train_fwd", "ffn_train_bwd")}
  alone = {}
  i = TRAIN_I
  for cd in (torch.bfloat16, torch.float32):
    for r, h in TRAIN_SHAPES:
      fargs, dy = train_inputs(torch, dropout, r, h, cd, dev, gen)
      _, drop, w1, _, w2, _, gamma, _ = fargs
      kw = dict(eps=1e-12, compute_dtype=cd)
      tag = f"R={r} H={h} I={i} {str(cd).replace('torch.', '')}"
      route = ffn.gemm_route(h, i, cd)
      fwd_out, err_f = check_train_kernel(
          torch, ffn, f"ffn_train_fwd {tag}", "ffn_train_fwd", cd, fargs, kw)
      _, inter, z = ffn.ffn_train_fwd_plain(*fargs, **kw)
      bargs = (dy, z, inter, drop, w1, w2, gamma)
      err_b = 0.0
      for add_dz in (True, False):
        got, err = check_train_kernel(
            torch, ffn, f"ffn_train_bwd {tag} add_dz={add_dz}",
            "ffn_train_bwd", cd, bargs, dict(kw, add_dz=add_dz))
        err_b = max(err_b, err)
        if add_dz:
          bwd_out = got
      # Both do the two products of the block, 4 R H I FLOP.
      calls = {"ffn_train_fwd": (fargs, kw, fwd_out),
               "ffn_train_bwd": (bargs, dict(kw, add_dz=True), bwd_out)}
      yard = gemms_ms(torch, fargs[0], w1, w2) if route else None
      for kname, err in (("ffn_train_fwd", err_f), ("ffn_train_bwd", err_b)):
        args, kkw, out = calls[kname]
        kernel, plain = (getattr(ffn, f"{kname}_cuda"),
                         getattr(ffn, f"{kname}_plain"))
        ms = time_ms(torch, lambda: kernel(*args, **kkw))
        plain_ms = time_ms(torch, lambda: plain(*args, **kkw))
        b_ms, b_by = bound(4 * r * h * i, H100_BF16, args + tuple(out))
        line = (f"{kname} {tag} ({'gemm' if route else 'wmma/fma'} route): "
                f"kernel_ms={ms:.4f} plain_ms={plain_ms:.4f} bound_ms="
                f"{b_ms:.4f} ({b_by})")
        if route:
          dev_ms = device_ms(torch, lambda: kernel(*args, **kkw))
          wmma = lambda: kernel(*args, **kkw, tile=-1)
          line += (f" device_ms={dev_ms:.4f} ({tflops(r, h, i, dev_ms):.1f} "
                   f"TFLOP/s) wmma_ms={time_ms(torch, wmma):.4f} "
                   f"wmma_device_ms={device_ms(torch, wmma):.4f} host_ms="
                   f"{host_ms(torch, lambda: kernel(*args, **kkw))} "
                   f"gemms_ms={yard:.4f} (two bf16 torch.mm alone)")
          alone.setdefault((r, h), {})[kname] = dev_ms
        print(f"{line} card: {card}", flush=True)
        if cd == torch.bfloat16:
          res[kname]["max_abs_err"] = max(res[kname]["max_abs_err"], err)
          if (r, h) == TRAIN_SHAPES[0]:
            res[kname].update(ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
                              bound_by=b_by)
  return res, alone


def reference_phase(torch, flagship, evaluate, dev):
  """Tiny fp32 CENet: card (kernels) vs CPU (plain versions)."""
  arch = flagship.flagship_arch(tiny=True)
  cpu = flagship.flagship_model(device="cpu", compute_dtype=torch.float32,
                                tiny=True, seed=1)
  gpu = flagship.flagship_model(device=dev, compute_dtype=torch.float32,
                                tiny=True, seed=1)
  gpu.load_state_dict(cpu.state_dict())
  raw = [flagship.make_batch(arch["expert_dims"], 8, vocab=512, seed=s)
         for s in (11, 12)]
  want = evaluate.retrieval_eval(
      cpu, [flagship.batch_to_torch(b, "cpu") for b in raw])
  got = evaluate.retrieval_eval(
      gpu, [flagship.batch_to_torch(b, dev) for b in raw])
  err = float((got["sims"].cpu() - want["sims"]).abs().max())
  print(f"reference: tiny fp32 CENet card vs CPU sims max_abs_err={err:.3e}",
        flush=True)
  if err > 1e-4:
    raise RuntimeError(f"card vs CPU sims differ by {err} > 1e-4")


TRAIN_BATCH, TRAIN_BIG_BATCH, TRAIN_LR, TRAIN_STEPS = 32, 128, 5e-5, 20
# Kernel path vs plain path, one b32 step from the same state and seed.
# The only difference is bf16 rounding: the kernels and the plain versions
# round an element of an intermediate to the neighbouring bf16 value now
# and then (a few per 1e4, train-kernel phase).  That moves the loss by
# ~1e-5 and all gradients together by ~1% (relative L2 over all
# parameters), but a parameter whose gradient is a small sum of cancelling
# terms (the last video layer's LayerNorm bias: 7 of 218 tokens carry
# gradient) moves by up to ~8% of its own norm.
STEP_LOSS_TOL, STEP_GRAD_TOL, STEP_ALL_GRADS_TOL = 1e-4, 0.2, 2e-2


def check_step(torch, what, loss, loss_ref, grads, grads_ref):
  """One train step against a reference step from the same state and
  seed: the loss within STEP_LOSS_TOL, all gradients together within
  STEP_ALL_GRADS_TOL relative L2 and each parameter's within
  STEP_GRAD_TOL.  Raises past them."""
  loss_diff = abs(loss - loss_ref)
  # Relative L2 difference per parameter, the denominator floored at 1e-2
  # of the median gradient norm: a gradient that is zero in exact
  # arithmetic is rounding noise on both paths (the attention key biases,
  # which the softmax cancels, and the biases in front of the train-mode
  # BatchNorm, which its batch mean cancels).
  diffs = {n: (float((grads[n].float() - g.float()).norm()),
               float(g.float().norm()))
           for n, g in grads_ref.items()}
  floor = 1e-2 * statistics.median(ref for _, ref in diffs.values())
  rel = {n: d / max(ref, floor) for n, (d, ref) in diffs.items()}
  worst_name = max(rel, key=rel.get)
  worst = rel[worst_name]
  top = sorted(rel, key=rel.get, reverse=True)[:5]
  overall = (sum(d * d for d, _ in diffs.values())
             / sum(ref * ref for _, ref in diffs.values())) ** 0.5
  print(f"{what}: loss {loss:.6f} vs {loss_ref:.6f} abs_diff="
        f"{loss_diff:.3e}; all grads rel L2 diff={overall:.3e}; worst grad "
        f"rel L2 diff={worst:.3e} ({worst_name}; norm floor {floor:.3e}); "
        "top: " + ", ".join(f"{n} {rel[n]:.3e} (|diff| {diffs[n][0]:.3e}, "
                            f"|grad| {diffs[n][1]:.3e})" for n in top),
        flush=True)
  if (not loss_diff <= STEP_LOSS_TOL or not worst <= STEP_GRAD_TOL
      or not overall <= STEP_ALL_GRADS_TOL):
    raise RuntimeError(f"{what}: loss diff {loss_diff} (tol {STEP_LOSS_TOL}),"
                       f" grad diff {worst} (tol {STEP_GRAD_TOL}, "
                       f"{worst_name}), all grads {overall} (tol "
                       f"{STEP_ALL_GRADS_TOL})")


def train_step_phase(torch, flagship, ops, ffn, similarity, dev, card):
  """The b32 train step of the full-width flagship (bf16): launch counts,
  kernel path vs plain path, 20 steps, then step times at b32 and b128.
  Returns the launch counts of the counted step, its loss and gradients
  (on the CPU) for the tensor-parallel phase, and ``step(batch_size,
  seed)``, one more kernel-path step of the timed run, for the train
  profile."""
  from mmt_tpu_torch.train import losses, optim, step

  arch = flagship.flagship_arch()
  model = flagship.flagship_model(device=dev, compute_dtype=torch.bfloat16,
                                  seed=0, train=True)
  spec = {"type": "Adam", "args": {"lr": TRAIN_LR, "weight_decay": 0}}
  loss_fn = losses.max_margin_ranking_loss(0.05, True)

  def make(batch_size, seed):
    return flagship.batch_to_torch(flagship.make_batch(
        arch["expert_dims"], batch_size, seed=seed), dev)

  def run(opt, batch, seed, plain=False):
    gen = torch.Generator(device=dev).manual_seed(seed)
    with ops.plain_versions() if plain else contextlib.nullcontext():
      return step.train_step(model, opt, batch, loss_fn=loss_fn,
                             lr=TRAIN_LR, generator=gen)

  batch = make(TRAIN_BATCH, 101)
  state0 = {k: v.clone() for k, v in model.state_dict().items()}

  # 1. One counted step on the kernel path.
  for fn in (ffn.ffn_block_cuda, ffn.ffn_train_fwd_cuda,
             ffn.ffn_train_bwd_cuda, similarity.sim_cuda):
    fn.launches = 0
  loss_k = run(optim.build_optimizer(spec, model.parameters())[0], batch, 7)
  torch.cuda.synchronize()
  launches = {"ffn_block": ffn.ffn_block_cuda.launches,
              "ffn_train_fwd": ffn.ffn_train_fwd_cuda.launches,
              "ffn_train_bwd": ffn.ffn_train_bwd_cuda.launches,
              "moe_similarity": similarity.sim_cuda.launches}
  print(f"train step launches: {launches}", flush=True)
  n_layers = FFN_LAYERS
  if (launches["ffn_train_fwd"] != n_layers
      or launches["ffn_train_bwd"] != n_layers
      or launches["moe_similarity"] < 1 or launches["ffn_block"] != 0):
    raise RuntimeError(f"expected {n_layers} B2, {n_layers} B3, >= 1 B4 and "
                       f"0 B1 launches per train step, got {launches}")
  grads_k = {n: p.grad.clone() for n, p in model.named_parameters()}

  # 2. The same step from the same state and seed on the plain path.
  model.load_state_dict(state0)
  loss_p = run(optim.build_optimizer(spec, model.parameters())[0], batch, 7,
               plain=True)
  torch.cuda.synchronize()
  check_step(torch, "train step kernel vs plain", float(loss_k),
             float(loss_p), grads_k,
             {n: p.grad for n, p in model.named_parameters()})
  loss_k = float(loss_k)
  grads_k = {n: g.cpu() for n, g in grads_k.items()}
  del state0

  # 3. 20 steps on one batch.
  opt = optim.build_optimizer(spec, model.parameters())[0]
  bn = next(iter(model.text_GU.values())).cg.batch_norm
  stats0 = (bn.running_mean.clone(), bn.running_var.clone())
  losses_seen = [float(run(opt, batch, 1000 + i))
                 for i in range(TRAIN_STEPS)]
  print(f"train {TRAIN_STEPS} steps on one batch: first loss "
        f"{losses_seen[0]:.6f} last {losses_seen[-1]:.6f} all: "
        f"{[round(x, 6) for x in losses_seen]}", flush=True)
  if not all(x == x and abs(x) != float("inf") for x in losses_seen):
    raise RuntimeError(f"non-finite train losses: {losses_seen}")
  moved = float((bn.running_mean - stats0[0]).abs().max()
                + (bn.running_var - stats0[1]).abs().max())
  if not moved > 0:
    raise RuntimeError("BatchNorm running statistics did not move")
  print(f"BatchNorm running stats moved by {moved:.3e}", flush=True)

  # 4. Step time, kernel and plain paths in turns.
  times = {}
  batches = {TRAIN_BATCH: batch, TRAIN_BIG_BATCH: make(TRAIN_BIG_BATCH, 202)}
  for batch_size, b in batches.items():
    runs = {False: [], True: []}
    for i in range(3 + TRAIN_STEPS):
      for plain in (False, True):
        torch.cuda.synchronize()
        tic = time.perf_counter()
        run(opt, b, 5000 + i, plain=plain)
        torch.cuda.synchronize()
        if i >= 3:
          runs[plain].append(time.perf_counter() - tic)
    k_ms = statistics.median(runs[False]) * 1e3
    p_ms = statistics.median(runs[True]) * 1e3
    times[batch_size] = (k_ms, p_ms)
    print(f"train step b{batch_size} (median of {TRAIN_STEPS}): "
          f"kernel_path_ms={k_ms:.3f} plain_path_ms={p_ms:.3f} "
          f"ratio={k_ms / p_ms:.4f} samples_per_s={batch_size * 1e3 / k_ms:.1f}"
          f" card: {card}", flush=True)
    print(f"train step b{batch_size} runs kernel_path_ms="
          f"{[round(x * 1e3, 3) for x in runs[False]]} plain_path_ms="
          f"{[round(x * 1e3, 3) for x in runs[True]]}", flush=True)
  return (launches, loss_k, grads_k,
          lambda batch_size, seed: run(opt, batches[batch_size], seed))


# Kernels of B2 and B3 on the GEMM route, as the profiler names them (the
# template GEMMs by their epilogues); the train step launches no B1, whose
# cast and GEMM 1 epilogue would share B2's names.
TRAIN_KERNELS = {
    "ffn_train_fwd": ("ffn_cast_bf16_kernel", "GeluInterEpilogue",
                      "DropResidualEpilogue", "ffn_ln_rows_kernel"),
    "ffn_train_bwd": ("ffn_transpose_bf16_kernel", "ffn_ln_bwd_rows_kernel",
                      "DgeluEpilogue", "AccumulateEpilogue")}
TRAIN_PROFILE_STEPS = 3
VIDEO_TOKENS, TEXT_TOKENS = 218, 30   # rows per sample of each tower's FFN


def train_alone_ms(torch, ffn, dropout, shape, dev, gen):
  """{kernel: (device ms, CUDA-event ms)} of one bf16 B2 and one B3 call
  at ``shape`` (rows, H)."""
  fargs, dy = train_inputs(torch, dropout, *shape, torch.bfloat16, dev, gen)
  kw = dict(eps=1e-12, compute_dtype=torch.bfloat16)
  _, inter, z = ffn.ffn_train_fwd_plain(*fargs, **kw)
  bargs = (dy, z, inter, fargs[1], fargs[2], fargs[4], fargs[6])
  calls = {"ffn_train_fwd": lambda: ffn.ffn_train_fwd_cuda(*fargs, **kw),
           "ffn_train_bwd": lambda: ffn.ffn_train_bwd_cuda(*bargs, **kw)}
  return {k: (device_ms(torch, fn), time_ms(torch, fn))
          for k, fn in calls.items()}


def train_profile_phase(torch, ffn, dropout, step, alone, dev, gen, card):
  """TRAIN_PROFILE_STEPS kernel-path steps at b32 and at b128 under
  torch.profiler, the card's SM clock and power sampled meanwhile: device
  time and the device's idle share of the wall, the device activities,
  B2's and B3's kernels in situ a call against their device time alone
  (phase 4's at b32; at b128's shapes measured right after the window,
  clock sampled too) times the launches, and the top device operations."""
  from torch.profiler import ProfilerActivity, profile

  counted = {k: getattr(ffn, f"{k}_cuda") for k in TRAIN_KERNELS}
  for batch_size in (TRAIN_BATCH, TRAIN_BIG_BATCH):
    video = (batch_size * VIDEO_TOKENS, 512)
    text = (batch_size * TEXT_TOKENS, 768)
    step(batch_size, 6000)                     # warm-up
    torch.cuda.synchronize()
    for fn in counted.values():
      fn.launches = 0
    with CardSampler() as card_in, profile(
        activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
      tic = time.perf_counter()
      for s in range(TRAIN_PROFILE_STEPS):
        step(batch_size, 6001 + s)
      torch.cuda.synchronize()
      wall_ms = (time.perf_counter() - tic) * 1e3
    launches = {k: fn.launches for k, fn in counted.items()}
    dev_us = lambda e: e.self_device_time_total
    on_dev = sorted(device_events(prof), key=dev_us, reverse=True)
    total_ms = sum(map(dev_us, on_dev)) / 1e3
    if not total_ms > 0:
      raise RuntimeError("the profiler recorded no device time")
    events = {}   # CUDA-event ms alone, where measured here
    with CardSampler() as card_alone:
      for shape in (video, text):
        if shape not in alone:
          both = train_alone_ms(torch, ffn, dropout, shape, dev, gen)
          alone[shape] = {k: d for k, (d, _) in both.items()}
          events[shape] = {k: e for k, (_, e) in both.items()}
    n = TRAIN_PROFILE_STEPS
    print(f"train profile b{batch_size}: {n} kernel-path steps, wall "
          f"{wall_ms:.3f} ms (under the profiler), device time {total_ms:.3f} "
          f"ms ({total_ms / n:.3f} a step) in "
          f"{sum(e.count for e in on_dev)} device activities, device idle "
          f"share {1 - total_ms / wall_ms:.4f}; {card_in.summary()} card: "
          f"{card}", flush=True)
    for kname, names in TRAIN_KERNELS.items():
      mine = [e for e in on_dev if any(k in e.key for k in names)]
      in_ms = sum(map(dev_us, mine)) / 1e3
      calls = launches[kname]
      want = FFN_LAYERS * n
      # Per step 4 video and 12 text blocks.
      alone_ms = n * (4 * alone[video][kname] + 12 * alone[text][kname])
      print(f"train profile b{batch_size}: {kname} in situ {in_ms:.3f} ms "
            f"({in_ms / total_ms:.2%} of device time; {calls} launches, "
            f"{sum(e.count for e in mine)} kernels; {in_ms / calls:.4f} ms a "
            f"call) against device time alone x launches {alone_ms:.3f} ms "
            f"(in situ / alone {in_ms / alone_ms:.4f}; alone: video "
            f"{alone[video][kname]:.4f}, text {alone[text][kname]:.4f} ms a "
            f"call)", flush=True)
      if events:
        # Calls of 0.1 ms and more: their event time is the device's.
        ev_ms = n * (4 * events[video][kname] + 12 * events[text][kname])
        print(f"  {kname} alone by CUDA events: video "
              f"{events[video][kname]:.4f}, text {events[text][kname]:.4f} "
              f"ms a call; in situ / alone {in_ms / ev_ms:.4f}", flush=True)
      for e in mine:
        print(f"  {kname} kernel {dev_us(e) / 1e3:.3f} ms x{e.count} "
              f"{e.key[:110]}", flush=True)
      if calls != want:
        raise RuntimeError(f"profiled steps launched {kname} {calls} times, "
                           f"not {want}")
    if batch_size != TRAIN_BATCH:
      print(f"train profile b{batch_size}: while timing B2 and B3 alone "
            f"{card_alone.summary()}", flush=True)
    for e in on_dev[:PROFILE_TOP]:
      print(f"  top device op {dev_us(e) / 1e3:.3f} ms "
            f"({dev_us(e) / 1e3 / total_ms:.2%}) x{e.count} {e.key[:110]}",
            flush=True)


# Rank-kernel cases: (name, videos, captions per video).  (a) 50k x 50k
# unit-norm random embeddings with all-zero weight rows; (b) 2,000
# captions x 1,000 videos with masked caption slots, a video whose slots
# are all masked and 24 padding videos; (c) exact arithmetic with
# duplicated rows (ties).
RANK_CASES = (("a", 50_000, 1), ("b", 1_000, 2), ("c", 1_000, 2))
RANK_M, RANK_D, RANK_PAD = 7, 512, 24


def rank_inputs(torch, case, nv, cpv, dev, gen):
  """te, ve, tw, vw, masks, vid_valid of one rank-kernel case."""
  q, m, d = nv * cpv, RANK_M, RANK_D
  masks = torch.ones(nv, cpv, device=dev)
  vid_valid = None
  if case == "c":
    # Values in {0, +-0.5, +-1} and unit weights: every partial sum is a
    # multiple of 0.25 below 2^22, exact in fp32 in any order, so kernel
    # and plain version must count alike.
    rand = lambda *sh: torch.randint(-2, 3, sh, generator=gen,
                                     device=dev).float() / 2
    te, ve = rand(q, m, d), rand(nv, m, d)
    ve[10] = ve[3]          # duplicates of GT rows: ties in t2v
    ve[20:25] = ve[0]
    te[100] = te[41]        # duplicate captions: ties in v2t
    te[7] = te[6]
    return (te, ve, torch.ones(q, m, device=dev), torch.ones(nv, m, device=dev),
            masks, vid_valid)
  te = torch.randn(q, m, d, generator=gen, device=dev)
  ve = torch.randn(nv, m, d, generator=gen, device=dev)
  te, ve = te / te.norm(dim=-1, keepdim=True), ve / ve.norm(dim=-1,
                                                          keepdim=True)
  tw = torch.rand(q, m, generator=gen, device=dev)
  vw = torch.rand(nv, m, generator=gen, device=dev)
  tw, vw = tw / tw.sum(-1, keepdim=True), vw / vw.sum(-1, keepdim=True)
  if case == "a":            # the denominator's 1e-5 guard
    tw[3] = 0.0
    vw[5] = 0.0
    vw[7] = 0.0
  else:
    masks = (torch.rand(nv, cpv, generator=gen, device=dev) > 0.1).float()
    masks[0] = 0.0           # every slot masked: v2t rank inf
    # Padding videos, as a mesh pads them: zero rows, dead in both
    # orientations.
    pad = RANK_PAD
    ve[-pad:], vw[-pad:], masks[-pad:] = 0.0, 0.0, 0.0
    te[-pad * cpv:], tw[-pad * cpv:] = 0.0, 0.0
    vid_valid = torch.ones(nv, device=dev)
    vid_valid[-pad:] = 0.0
  return te, ve, tw, vw, masks, vid_valid


def rank_agreement(torch, got, want):
  """(worst |diff| over ranks finite in both, share of them that differ,
  whether the inf positions agree)."""
  inf_g, inf_w = torch.isinf(got), torch.isinf(want)
  fin = ~inf_g & ~inf_w
  diff = (got[fin] - want[fin]).abs()
  worst = float(diff.max()) if diff.numel() else 0.0
  return worst, float((diff > 0).float().mean()), bool(torch.equal(inf_g,
                                                                   inf_w))


# The JAX package's rule for the fused ranks, every rank within 1 on
# fewer than 1e-3 of the queries, is a rate: it is held where 1e-3 of the
# queries is at least 10 of them.  On fewer queries it would demand that
# no GT have a near tie at all, which depends on the draw; there phase 3
# holds each call instead to the fp64 witness of check_counts_witness.
RANK_SHARE_MIN_QUERIES = 10_000


def check_rank_rule(torch, what, got, want):
  """Same inf positions; finite ranks within 1, and from
  RANK_SHARE_MIN_QUERIES queries on fewer than 1e-3 of them.  Returns
  the worst |diff|."""
  worst, frac, same_inf = rank_agreement(torch, got, want)
  held = got.numel() >= RANK_SHARE_MIN_QUERIES
  print(f"  {what}: worst rank diff {worst} on {frac:.3e} of queries"
        f"{'' if held else ' (share rule from 10,000 queries)'}, same inf "
        f"positions {same_inf}", flush=True)
  if not same_inf or worst > 1 or (held and frac >= 1e-3):
    raise RuntimeError(f"{what}: ranks outside the rule (worst {worst}, "
                       f"share {frac}, same inf {same_inf})")
  return worst


def check_counts_witness(torch, ranking, what, args, got, want,
                         kernel_sims=None):
  """One draw of two fp32 sum orders (kernel and plain version): a query's
  counts may differ only by candidates whose exact similarity lies within
  fp32 sum-order noise of the GT value both compare with.  For each query
  that differs: s64, its fp64 similarities; its noise, the largest
  |s32 - s64| over its live candidates of the fp32 values of the plain
  formula (torch.mm) and of ``kernel_sims`` (B4, whose values are B5's
  bits); its |difference of closer + tied / 2| must not exceed its
  candidates c != gtcol with |s64 - gt| <= 2 noise.  Prints the differing
  queries beside the witness; raises otherwise."""
  queries, cands, qw, cw, gt, gtcol, colbias = args
  diff = ((got[0] + got[1] / 2) - (want[0] + want[1] / 2)).abs()
  rows = torch.nonzero(diff > 0)[:, 0]
  if rows.numel() == 0:
    return
  q, qws = queries[rows].contiguous(), qw[rows].contiguous()
  guard = lambda d: torch.where(d == 0, torch.full_like(
      d, ranking.EPS_ZERO_GUARD), d)
  s64 = (q.double() @ cands.double().T) / guard(qws.double()
                                                @ cw.double().T)
  fp32 = [(q @ cands.T) / guard(qws @ cw.T)]
  if kernel_sims is not None:
    fp32.append(kernel_sims(q, cands, qws, cw))
  live = (colbias == 0)[None, :]
  noise = torch.stack([torch.where(live, (s - s64).abs(), 0.0).amax(1)
                       for s in fp32]).amax(0)
  gap = (s64 + colbias.double() - gt[rows].double()[:, None]).abs()
  own = gtcol[rows].long()
  gap[torch.arange(rows.numel(), device=gap.device)[own >= 0],
      own[own >= 0]] = float("inf")
  n_near = (gap <= 2 * noise[:, None]).sum(1)
  ok = bool((diff[rows] <= n_near).all())
  print(f"  {what}: {rows.numel()} queries' counts differ (largest by "
        f"{float(diff.max())}); each within its candidates inside twice the "
        f"fp32 sum-order noise of the GT (fp64 witness): {ok}", flush=True)
  for j in range(min(rows.numel(), 4)):
    c = int(gap[j].argmin())
    print(f"    query {int(rows[j])}: differs by {float(diff[rows[j]])}, GT "
          f"{float(gt[rows[j]]):.9e}, nearest candidate {c} at fp64 "
          f"{float(s64[j, c]):.12e} (|s64 - GT| {float(gap[j, c]):.3e}, "
          f"noise {float(noise[j]):.3e}), {int(n_near[j])} within twice the "
          "noise", flush=True)
  if not ok:
    raise RuntimeError(f"{what}: counts differ beyond fp32 sum-order noise "
                       "of the GT")


def counts_bound(torch, args):
  """Bound of one fused-counts call: its FMAs (2 Q C (K + M)) at the fp32
  rate, its operands and two [Q] int32 counts at the memory rate."""
  q, k = args[0].shape
  c, m = args[3].shape
  out = torch.empty(2 * q, dtype=torch.int32, device=args[0].device)
  return bound(2 * q * c * (k + m), H100_FP32, tuple(args) + (out,))


def matrix_counts(torch, similarity, args, tile=None):
  """The (closer, tied) counts of one fused-counts call, taken from the
  similarity kernel's own [Q, C] matrix."""
  queries, cands, qw, cw, gt, gtcol, colbias = args
  sims = similarity.sim_cuda(queries, cands, qw, cw, tile=tile) + colbias[None]
  col = torch.arange(cands.shape[0], device=cands.device)
  valid = col[None, :] != gtcol[:, None]
  return ((valid & (sims > gt[:, None])).sum(1).float(),
          (valid & (sims == gt[:, None])).sum(1).float())


def check_counts_equal_matrix(torch, ranking, similarity, what, args, got):
  """B5 compares bitwise B4's values: its counts, in every tile shape,
  equal those of B4's matrix as integers."""
  want = matrix_counts(torch, similarity, args)
  same = [all(torch.equal(g, w) for g, w in zip(got, want))]
  for i in range(len(similarity.TILES)):
    out = ranking.fused_counts_cuda(*args, tile=i)
    same.append(all(torch.equal(g, w) for g, w in zip(out, want)))
    same.append(all(torch.equal(g, w) for g, w in zip(
        matrix_counts(torch, similarity, args, tile=i), want)))
  print(f"  {what}: counts equal those of the similarity kernel's matrix "
        f"(as called, then each tile shape of B5 and of B4): {same}",
        flush=True)
  if not all(same):
    raise RuntimeError(f"{what}: fused counts differ from the counts of "
                       "the similarity kernel's matrix")


def rank_kernel_phase(torch, ranking, similarity, dev, gen, card):
  """B5 against its plain version on the card, each case in both
  orientations; returns the worst rank disagreement."""
  worst_all = 0.0
  for case, nv, cpv in RANK_CASES:
    te, ve, tw, vw, masks, vid_valid = rank_inputs(torch, case, nv, cpv,
                                                   dev, gen)
    for orient in ("t2v", "v2t"):
      ranks, logs = {}, {}
      for name, fn in (("kernel", ranking.fused_counts_cuda),
                       ("plain", ranking.fused_counts_plain)):
        log = logs[name] = []

        def counted(*a, fn=fn, log=log):
          out = fn(*a)
          log.append((a, out))
          return out

        ranks[name] = (
            ranking._t2v_ranks_from_counts(counted, te, ve, tw, vw, vid_valid)
            if orient == "t2v" else
            ranking._v2t_ranks_from_counts(counted, te, ve, tw, vw, masks))
      torch.cuda.synchronize()
      what = f"fused_ranks case ({case}) {orient} {nv * cpv} x {nv}"
      worst_all = max(worst_all, check_rank_rule(
          torch, f"{what} kernel vs plain", ranks["kernel"], ranks["plain"]))
      for n_call, (k, p) in enumerate(zip(logs["kernel"], logs["plain"])):
        check_counts_witness(torch, ranking, f"{what} call {n_call}", k[0],
                             k[1], p[1], similarity.sim_cuda)
      if case == "c":
        pairs = list(zip(logs["kernel"], logs["plain"]))
        equal = all(torch.equal(k[1][0], p[1][0]) and torch.equal(k[1][1],
                                                                  p[1][1])
                    for k, p in pairs)
        max_tied = max(float(k[1][1].max()) for k, _ in pairs)
        print(f"  exact case: counts equal {equal}, largest tied count "
              f"{max_tied}", flush=True)
        if not equal or not max_tied > 0:
          raise RuntimeError("exact case: kernel and plain counts differ or "
                             "no tie was counted")
      if case in ("b", "c"):
        for n_call, (a, out) in enumerate(logs["kernel"]):
          check_counts_equal_matrix(torch, ranking, similarity,
                                    f"{what} call {n_call}", a, out)
      if case == "b" and orient == "v2t":
        if not (torch.isinf(ranks["kernel"][0])
                and torch.isinf(ranks["plain"][0])):
          raise RuntimeError("a video with every slot masked must rank inf")
      args = logs["kernel"][0][0]
      reps = 3 if nv > 10_000 else 10
      ms = time_ms(torch, lambda: ranking.fused_counts_cuda(*args), reps)
      plain_ms = time_ms(torch, lambda: ranking.fused_counts_plain(*args),
                         reps)
      lib_ms = time_ms(torch, lambda: torch.mm(args[0], args[1].T), reps)
      b_ms, b_by = counts_bound(torch, args)
      print(f"{what} (one counts call, {len(logs['kernel'])} per "
            f"orientation): kernel_ms={ms:.4f} plain_ms={plain_ms:.4f} "
            f"library_ms={lib_ms:.4f} (torch.mm of the numerator) "
            f"bound_ms={b_ms:.4f} ({b_by}) card: {card}", flush=True)
    del te, ve, tw, vw
    torch.cuda.empty_cache()

  # K = 3,586 (no multiple of 4 or of the slice depth), ragged Q and C and
  # dead candidates: against the plain version with each query's GT value
  # computed directly, as the ranks do; then with GT values read from the
  # similarity kernel's matrix, so that ties exist, against its counts.
  gen = torch.Generator(device=dev).manual_seed(3)   # see sim_phase
  q, c = 300, 500
  t, cc, tw, cw = sim_inputs(torch, q, c, 2, 1793, dev, gen)
  gtcol = torch.randint(0, c, (q,), generator=gen, device=dev)
  colbias = torch.zeros(c, device=dev)
  colbias[::7] = -ranking.MISSING_VAL
  what = f"fused_ranks {q} x {c} K={t.shape[1]}"
  args = (t, cc, tw, cw, ranking._gt_sims(t, cc, tw, cw, gtcol), gtcol,
          colbias)
  got, want = (fn(*args) for fn in (ranking.fused_counts_cuda,
                                    ranking.fused_counts_plain))
  worst_all = max(worst_all, check_rank_rule(
      torch, f"{what} kernel vs plain", got[0] + got[1] / 2,
      want[0] + want[1] / 2))
  check_counts_witness(torch, ranking, what, args, got, want,
                       similarity.sim_cuda)
  other = torch.randint(0, c, (q, 1), generator=gen, device=dev)
  args = (t, cc, tw, cw,
          similarity.sim_cuda(t, cc, tw, cw).gather(1, other)[:, 0], gtcol,
          colbias)
  got = ranking.fused_counts_cuda(*args)
  check_counts_equal_matrix(torch, ranking, similarity, what, args, got)
  if not float(got[1].sum()) > 0:
    raise RuntimeError(f"{what}: no tie was counted")
  return worst_all


AT_SCALE_VIDEOS = 20_000


def between_gts(torch, a, g_fused, gtcol):
  """Per row of a [rows, candidates] similarity matrix: the candidates
  other than the GT column whose similarity lies between the fused path's
  GT value and the matrix's (both included)."""
  g_matrix = a.gather(1, gtcol[:, None])[:, 0]
  lo = torch.minimum(g_fused, g_matrix)[:, None]
  hi = torch.maximum(g_fused, g_matrix)[:, None]
  return ((a >= lo) & (a <= hi)).sum(1) - 1


def at_scale_phase(torch, modules, model, staged, dev, card):
  """The fused eval at 20,000 videos (bench.py's streaming protocol):
  launch counts, kernel vs plain and fused vs matrix ranks on the same
  embeddings, peak memory, B5's time at this shape, and the eval's wall
  time on both paths.  Returns the B5 line entries."""
  bench, evaluate, metrics, ops, ffn, similarity, ranking = modules
  n = AT_SCALE_VIDEOS
  vocab = model.txt_bert.cfg.vocab_size
  passes = lambda: bench.salted_passes(staged, n, vocab)

  # 1. The main path, counted.
  for fn in (ffn.ffn_block_cuda, similarity.sim_cuda,
             ranking.fused_counts_cuda):
    fn.launches = 0
  tic = time.perf_counter()
  res = evaluate.retrieval_eval(model, passes(), fused=True)
  torch.cuda.synchronize()
  first_s = time.perf_counter() - tic
  launches = {"ffn_block": ffn.ffn_block_cuda.launches,
              "moe_similarity": similarity.sim_cuda.launches,
              "fused_ranks": ranking.fused_counts_cuda.launches}
  print(f"at-scale: fused eval of {n} videos ({n // CHUNK} chunks of {CHUNK},"
        f" {n // N_VIDEOS} salted passes) in {first_s:.3f} s; launches "
        f"{launches}", flush=True)
  want = {"ffn_block": FFN_LAYERS * (n // CHUNK), "moe_similarity": 0,
          "fused_ranks": 2}       # t2v + one per caption slot (cpv = 1)
  if launches != want:
    raise RuntimeError(f"expected launches {want}, got {launches}")
  if "sims" in res:
    raise RuntimeError("the fused eval returned a sims matrix")
  finite_metrics(res)

  # 2. The same run's embeddings, ranked on the kernel path, the plain
  # path and the matrix path (B4 + the matrix ranks).
  emb = evaluate.embed_corpus(model, passes())
  te, ve, tw, vw, masks = (emb[k] for k in (
      "text_embds", "vid_embds", "text_weights", "vid_weights",
      "query_masks"))
  if masks.shape != (n, 1) or not bool(masks.all()):
    raise RuntimeError("the at-scale corpus has one live caption per video")
  base = torch.cuda.memory_allocated()
  torch.cuda.reset_peak_memory_stats()
  with torch.inference_mode():
    kern = {"t2v": ranking.fused_t2v_ranks(te, ve, tw, vw),
            "v2t": ranking.fused_v2t_ranks(te, ve, tw, vw, masks)}
    torch.cuda.synchronize()
    peak_fused = torch.cuda.max_memory_allocated() - base
    with ops.plain_versions():
      plain = {"t2v": ranking.fused_t2v_ranks(te, ve, tw, vw),
               "v2t": ranking.fused_v2t_ranks(te, ve, tw, vw, masks)}
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    sims = similarity.moe_similarity(te, ve, tw, vw, merge="indep",
                                     num_caps=1)
    matrix = {"t2v": ranking.t2v_ranks(sims),
              "v2t": ranking.v2t_ranks(sims, masks)}
    torch.cuda.synchronize()
    peak_matrix = torch.cuda.max_memory_allocated() - base
  print(f"at-scale peak device memory above the {base / 2**30:.3f} GiB "
        f"resident (embeddings, inputs, weights): fused ranking "
        f"{peak_fused / 2**30:.3f} GiB, matrix ranking "
        f"{peak_matrix / 2**30:.3f} GiB card: {card}", flush=True)

  worst = 0.0
  t, tws = ranking._scaled_flat(te, tw)
  v, vws = ranking._scaled_flat(ve, vw)
  gtcol = torch.arange(n, device=dev)
  for orient, a, g in (
      ("t2v", sims, ranking._gt_sims(t, v, tws, vws, gtcol)),
      ("v2t", sims.T, ranking._gt_sims(v, t, vws, tws, gtcol))):
    worst = max(worst, check_rank_rule(
        torch, f"at-scale {orient} kernel vs plain", kern[orient],
        plain[orient]))
    # Fused vs matrix: the candidates' values are bitwise equal (one tile
    # code), the GT value is not (computed directly on the fused path, read
    # from the matrix on the other), so a rank may differ by the
    # candidates that lie between the two GT values, and by nothing else.
    m_worst, frac, same_inf = rank_agreement(torch, kern[orient],
                                             matrix[orient])
    slack = between_gts(torch, a, g, gtcol)
    diff = (kern[orient] - matrix[orient]).abs()
    explained = bool((diff <= slack).all())
    g_m = a.gather(1, gtcol[:, None])[:, 0]
    print(f"  at-scale {orient} fused vs matrix: worst rank diff {m_worst} "
          f"on {frac:.3e} of queries (the 1 / 1e-3 rule "
          f"{'met' if m_worst <= 1 and frac < 1e-3 else 'NOT met'}); GT "
          f"values differ on {float((g != g_m).float().mean()):.3e} of "
          f"queries, by at most {float((g - g_m).abs().max()):.3e}; every "
          f"difference within the candidates between the two GT values: "
          f"{explained}; same inf positions {same_inf}", flush=True)
    if not explained or not same_inf:
      raise RuntimeError(f"at-scale {orient}: fused and matrix ranks differ "
                         "beyond the GT's rounding")
  side = {}
  for name, ranks in (("fused kernel", kern), ("fused plain", plain),
                      ("matrix", matrix)):
    side[name] = {o: {k: v for k, v in metrics.cols2metrics(
        ranks[o].cpu().numpy(), n).items() if k in ("R1", "R5", "R10",
                                                     "MedR")}
                  for o in ("t2v", "v2t")}
  print(f"at-scale metrics side by side: {json.dumps(side)}", flush=True)
  same = all(metrics.cols2metrics(kern[o].cpu().numpy(), n) == res[w]
             for o, w in (("t2v", "t2v_metrics"), ("v2t", "v2t_metrics")))
  print(f"at-scale: the counted run's metrics equal these kernel ranks' "
        f"{same}", flush=True)
  del sims, matrix

  # 3. B5 at this shape (t2v operands), against its plain version and
  # the fp32 torch.mm of the numerator.
  args = (t, v, tws, vws, ranking._gt_sims(t, v, tws, vws, gtcol), gtcol,
          torch.zeros(n, device=dev))
  ms = time_ms(torch, lambda: ranking.fused_counts_cuda(*args), 5)
  plain_ms = time_ms(torch, lambda: ranking.fused_counts_plain(*args), 5)
  lib_ms = time_ms(torch, lambda: torch.mm(t, v.T), 5)
  b_ms, b_by = counts_bound(torch, args)
  print(f"fused_ranks {n} x {n} (one counts call): kernel_ms={ms:.4f} "
        f"plain_ms={plain_ms:.4f} library_ms={lib_ms:.4f} bound_ms="
        f"{b_ms:.4f} ({b_by}) card: {card}", flush=True)
  del emb, te, ve, tw, vw, t, v, args, kern, plain
  torch.cuda.empty_cache()

  # 4. Wall time of the fused eval, kernel and plain paths in turns.
  def wall(plain_path):
    torch.cuda.synchronize()
    tic = time.perf_counter()
    with ops.plain_versions() if plain_path else contextlib.nullcontext():
      evaluate.retrieval_eval(model, passes(), fused=True)
    torch.cuda.synchronize()
    return time.perf_counter() - tic

  wall(False)
  wall(True)
  runs = {False: [], True: []}
  for _ in range(3):
    for plain_path in (False, True):
      runs[plain_path].append(wall(plain_path))
  k_s, p_s = statistics.median(runs[False]), statistics.median(runs[True])
  print(f"fused eval {n} videos wall (median of 3): kernel_path_s={k_s:.6f} "
        f"plain_path_s={p_s:.6f} ratio={k_s / p_s:.4f} "
        f"videos_per_s={n / k_s:.1f} card: {card}", flush=True)
  print(f"fused eval runs kernel_path_s={[round(x, 6) for x in runs[False]]} "
        f"plain_path_s={[round(x, 6) for x in runs[True]]}", flush=True)
  return {"launches": launches["fused_ranks"], "max_abs_err": worst,
          "ms": ms, "plain_ms": plain_ms, "library_ms": lib_ms,
          "bound_ms": b_ms, "bound_by": b_by}


TP_SIZE, TP_I = 2, 3072 // 2     # two ranks: each holds I/mp of I = 3072
# B6's (1013, 192) is off the GEMM route: the WMMA kernel.
PARTIAL_SHAPES = {"ffn_partial": ((10900, 512), (1500, 768), (1013, 768),
                                  (1013, 192)),
                  "ffn_train_fwd_partial": ((6976, 512), (960, 768),
                                            (1013, 768))}


def check_partial(torch, what, cd, got, want, cd_names):
  """``check_outputs`` for a partial, which is not normalised: each fp32
  output divided by the plain version's largest magnitude, so that its
  rules hold relative to the partial's scale.  Returns the worst max abs
  error of the fp32 outputs, unscaled."""
  scale = {n: float(want[n].abs().max()) for n in want if n not in cd_names}
  print(f"  {what} scale (max |plain|): "
        + ", ".join(f"{n} {v:.3e}" for n, v in scale.items()), flush=True)
  div = lambda d: {n: t / scale[n] if n in scale else t for n, t in d.items()}
  check_outputs(torch, what, cd, div(got), div(want), cd_names)
  return max(float((got[n] - want[n]).abs().max()) for n in scale)


def check_b7_is_b6(torch, ffn, what, args, kw):
  """B7's partial is B6's, bit for bit, in every row tile of the GEMM
  route: GEMM 1 computes g alike under both epilogues and GEMM 2 is the
  same.  Raises otherwise."""
  same = [torch.equal(ffn.ffn_train_fwd_partial_cuda(*args, **kw,
                                                     tile=t)[0],
                      ffn.ffn_partial_cuda(*args, **kw, tile=t))
          for t in range(len(ffn.GEMM_TILES))]
  print(f"  {what} out bitwise equal to ffn_partial's by row tile "
        f"{ffn.GEMM_TILES}: {same}", flush=True)
  if not all(same):
    raise RuntimeError(f"{what}: B7's partial differs from B6's")


def partial_kernel_phase(torch, ffn, dropout, dev, gen, card):
  """B6 and B7, and B3 with add_dz off on B7's residuals, against their
  plain versions at the two-rank shapes (I/mp = 1536), bf16 and fp32; on
  the GEMM route B7 also against its WMMA kernel (``tile=-1``) and B6.
  Returns B6's and B7's line entries: the worst bf16 error, and the
  video-shape bf16 times and bound (no single PyTorch call computes
  either)."""
  res = {name: {"max_abs_err": 0.0, "library_ms": None}
         for name in PARTIAL_SHAPES}
  i = TP_I
  for cd in (torch.bfloat16, torch.float32):
    for kname, shapes in PARTIAL_SHAPES.items():
      train = kname == "ffn_train_fwd_partial"
      kfn, pfn = getattr(ffn, f"{kname}_cuda"), getattr(ffn, f"{kname}_plain")
      names = ("out", "inter") if train else ("out",)
      outs = lambda t: dict(zip(names, t if train else (t,)))
      for r, h in shapes:
        rand = lambda *sh: torch.randn(*sh, generator=gen, device=dev)
        x = rand(r, h)
        w1, w2 = (rand(i, h) * 0.02).to(cd), (rand(h, i) * 0.02).to(cd)
        args, kw = (x, w1, rand(i) * 0.02, w2), dict(compute_dtype=cd)
        tag = f"R={r} H={h} I={i} {str(cd).replace('torch.', '')}"
        route = ffn.gemm_route(h, i, cd)
        got, want = outs(kfn(*args, **kw)), outs(pfn(*args, **kw))
        torch.cuda.synchronize()
        err = check_partial(torch, f"{kname} {tag}", cd, got, want,
                            ("inter",))
        ms = time_ms(torch, lambda: kfn(*args, **kw))
        plain_ms = time_ms(torch, lambda: pfn(*args, **kw))
        b_ms, b_by = bound(4 * r * h * i, H100_BF16,
                           args + tuple(got.values()))
        extra, dev_ms = "", None
        if cd == torch.bfloat16:
          split = device_split(torch, lambda: kfn(*args, **kw))
          dev_ms = sum(split.values())
          extra = (f" device_ms={dev_ms:.4f} ({tflops(r, h, i, dev_ms):.1f} "
                   "TFLOP/s) by kernel {" + ", ".join(
                       f"{short_kernel_name(k)}: {v:.4f}"
                       for k, v in split.items()) + "}")
        if cd == torch.bfloat16 and not train:
          extra += (f" gemms_ms={gemms_ms(torch, x, w1, w2):.4f} (two bf16 "
                    "torch.mm alone)")
        if route and train:
          wmma = lambda: kfn(*args, **kw, tile=-1)
          check_partial(torch, f"{kname} {tag} vs WMMA kernel", cd, got,
                        outs(wmma()), ("inter",))
          check_b7_is_b6(torch, ffn, f"{kname} {tag}", args, kw)
          extra += (f" wmma_ms={time_ms(torch, wmma):.4f} wmma_device_ms="
                    f"{device_ms(torch, wmma):.4f} host_ms="
                    f"{host_ms(torch, lambda: kfn(*args, **kw))}")
        print(f"{kname} {tag} ({'gemm' if route else 'wmma/fma'} route): "
              f"kernel_ms={ms:.4f} ({tflops(r, h, i, ms):.1f} TFLOP/s) "
              f"plain_ms={plain_ms:.4f} bound_ms={b_ms:.4f} ({b_by}){extra} "
              f"card: {card}", flush=True)
        if route and r != 1013:
          check_tiles_equal(torch, ffn, f"{kname} {tag}", kfn, args, kw)
        if cd == torch.bfloat16:
          res[kname]["max_abs_err"] = max(res[kname]["max_abs_err"], err)
          if (r, h) == shapes[0]:
            res[kname].update(ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
                              bound_by=b_by, device_ms=dev_ms)
        if not train:
          continue
        # B3 as the tensor-parallel backward runs it, on B7's residuals.
        drop = dropout.dropout_mask((r, h), TRAIN_P, gen, dev)
        z = (want["out"] + x).to(cd)
        bargs = (rand(r, h), z, want["inter"], drop, w1, w2,
                 1.0 + 0.1 * rand(h))
        bkw = dict(eps=1e-12, compute_dtype=cd, add_dz=False)
        got_b, _ = check_train_kernel(
            torch, ffn, f"ffn_train_bwd add_dz=False {tag}", "ffn_train_bwd",
            cd, bargs, bkw, i, check_partial)
        kernel = lambda tile=None: ffn.ffn_train_bwd_cuda(*bargs, **bkw,
                                                          tile=tile)
        ms = time_ms(torch, kernel)
        plain_ms = time_ms(torch,
                           lambda: ffn.ffn_train_bwd_plain(*bargs, **bkw))
        b_ms, b_by = bound(4 * r * h * i, H100_BF16, bargs + tuple(got_b))
        extra = ""
        if ffn.gemm_route(h, i, cd):
          dev_ms, wmma = device_ms(torch, kernel), lambda: kernel(-1)
          extra = (f" device_ms={dev_ms:.4f} ({tflops(r, h, i, dev_ms):.1f} "
                   f"TFLOP/s) wmma_ms={time_ms(torch, wmma):.4f} "
                   f"wmma_device_ms={device_ms(torch, wmma):.4f}")
        print(f"ffn_train_bwd add_dz=False {tag}: kernel_ms={ms:.4f} "
              f"plain_ms={plain_ms:.4f} bound_ms={b_ms:.4f} ({b_by}){extra} "
              f"card: {card}", flush=True)
  return res


TP_EVAL_VIDEOS, TP_TIMED_EVALS, TP_TIMED_STEPS = N_VIDEOS, 2, 5
TP_TIMEOUT = 900.0
# TP eval sims against the single-device kernel path: only the order of
# the FFN's fp32 sums and one bf16 rounding of the reduced partial differ,
# which moved the sims by 6.8e-4 at most on an H100 (about as far as the
# kernel path is from the plain one); 5e-3 leaves room for that, not for a
# wrong shard, bias or reduce.
TP_SIMS_TOL = 5e-3
# The fp32 all-reduces of the TP path, [rows, H] with the count of each
# per eval (20 chunks of 50: 2 per layer, forward only) and per step (4
# per layer: 2 forward, 2 backward): video then text tower.
TP_REDUCES = {"eval": (((50 * 218, 512), 2 * 4 * 20), ((50 * 30, 768),
                                                       2 * 12 * 20)),
              "step": (((32 * 218, 512), 4 * 4), ((32 * 30, 768), 4 * 12))}
# The launch counters a rank reads, by the names of the kernels line.
COUNTED = {"ffn_block": "ffn_block_cuda", "ffn_partial": "ffn_partial_cuda",
           "ffn_train_fwd": "ffn_train_fwd_cuda",
           "ffn_train_fwd_partial": "ffn_train_fwd_partial_cuda",
           "ffn_train_bwd": "ffn_train_bwd_cuda"}


def tp_rank(tp, device, tiny, videos):
  """One rank of the tensor-parallel phase (run by ``parallel.spawn``):
  the 1k x 1k eval of the slice phase and the b32 step of the train-step
  phase on this rank's shards of the same model.  Returns numpy arrays
  and Python values; the gathered gradients on rank 0 only."""
  import hashlib

  import torch
  torch.backends.cuda.matmul.allow_tf32 = False
  torch.backends.cudnn.allow_tf32 = False
  from mmt_tpu_torch import bench, convert, evaluate, flagship
  from mmt_tpu_torch.ops import ffn, similarity
  from mmt_tpu_torch.train import losses, optim, step

  dev = torch.device(device)
  counters = {n: getattr(ffn, f) for n, f in COUNTED.items()}
  counters["moe_similarity"] = similarity.sim_cuda

  def reset():
    for fn in counters.values():
      fn.launches = 0

  def sync():
    if dev.type == "cuda":
      torch.cuda.synchronize(dev)

  def timed(fn):
    sync()
    tic = time.perf_counter()
    fn()
    sync()
    return time.perf_counter() - tic

  out = {}
  model, batches = bench.staged_flagship(dev, tiny=tiny, videos=videos,
                                         tp=tp)
  reset()
  res = evaluate.retrieval_eval(model, batches)
  sync()
  out["eval_launches"] = {n: fn.launches for n, fn in counters.items()}
  out["sims"] = res["sims"].cpu().numpy()
  out["eval_wall_s"] = [timed(lambda: evaluate.retrieval_eval(model, batches))
                        for _ in range(TP_TIMED_EVALS)]
  del model, batches, res

  arch = flagship.flagship_arch(tiny=tiny)
  model = flagship.flagship_model(device=dev, compute_dtype=torch.bfloat16,
                                  seed=0, tiny=tiny, train=True, tp=tp)
  vocab = dict(vocab=bench.TINY_VOCAB) if tiny else {}
  batch = flagship.batch_to_torch(flagship.make_batch(
      arch["expert_dims"], TRAIN_BATCH, seed=101, **vocab), dev)
  opt = optim.build_optimizer({"type": "Adam", "args": {
      "lr": TRAIN_LR, "weight_decay": 0}}, model.parameters())[0]
  loss_fn = losses.max_margin_ranking_loss(0.05, True)

  def run(seed):
    return step.train_step(model, opt, batch, loss_fn=loss_fn, lr=TRAIN_LR,
                           generator=torch.Generator(device=dev)
                           .manual_seed(seed))

  reset()
  out["loss"] = float(run(7))      # the train-step phase's counted step
  sync()
  out["step_launches"] = {n: fn.launches for n, fn in counters.items()}
  grads = convert.gather_state_dict(
      {n: p.grad for n, p in model.named_parameters()}, tp,
      model.shard_dims)
  out["grads"] = ({n: g.numpy() for n, g in grads.items()} if tp.rank == 0
                  else None)
  del grads
  for seed in (8, 9):
    run(seed)
  sync()
  out["replicated"] = {
      n: hashlib.sha256(t.detach().cpu().numpy().tobytes()).hexdigest()
      for n, t in [*model.named_parameters(), *model.named_buffers()]
      if n not in model.shard_dims}
  out["step_wall_s"] = [timed(lambda i=i: run(100 + i))
                        for i in range(TP_TIMED_STEPS)]
  del model, opt, batch

  # One fp32 all-reduce of each shape the path reduces, mean of 10.
  out["reduce_s"] = {}
  for what, shapes in TP_REDUCES.items():
    for shape, _ in shapes:
      x = torch.ones(shape, device=dev)
      tp.all_reduce(x)
      out["reduce_s"][shape] = sum(timed(lambda: tp.all_reduce(x))
                                   for _ in range(10)) / 10
  return out


def check_tp_launches(results):
  """Per rank: 320 B6 and 0 B1 per eval (>= 1 B4); 16 B7 and 16 B3, 0
  B1, B2 and B6 per step (>= 1 B4)."""
  n_eval = FFN_LAYERS * (TP_EVAL_VIDEOS // CHUNK)
  none = dict(ffn_partial=0, ffn_block=0, ffn_train_fwd=0,
              ffn_train_fwd_partial=0, ffn_train_bwd=0)
  want_ev = dict(none, ffn_partial=n_eval)
  want_st = dict(none, ffn_train_fwd_partial=FFN_LAYERS,
                 ffn_train_bwd=FFN_LAYERS)
  for rank, r in enumerate(results):
    ev, st = r["eval_launches"], r["step_launches"]
    print(f"tp rank {rank} launches: eval {ev}; step {st}", flush=True)
    if (any(ev[n] != v for n, v in want_ev.items())
        or any(st[n] != v for n, v in want_st.items())
        or ev["moe_similarity"] < 1 or st["moe_similarity"] < 1):
      raise RuntimeError(f"tp rank {rank}: expected eval launches {want_ev} "
                         f"and step launches {want_st} (>= 1 B4 each), got "
                         f"{ev} and {st}")


def check_tp_ranks(torch, ranking, sims, ref):
  """The ranks of the tensor-parallel sims against the single-device
  ones.  Prints whether the rank rule of phase 3 holds (every rank within
  1, on < 1e-3 of queries; random weights pack the sims so tightly that
  it is not expected to); raises unless every difference is one that
  sims within TP_SIMS_TOL allow: a candidate can change sides of the GT
  only if their two similarities lie within 2 x TP_SIMS_TOL of each
  other, so a rank may move by at most the number of such candidates."""
  n = sims.shape[0]
  masks = torch.ones(n, 1, device=sims.device)
  d = TP_SIMS_TOL
  gt = torch.arange(n, device=sims.device)
  ranks = {"t2v": lambda a: ranking.t2v_ranks(a),
           "v2t": lambda a: ranking.v2t_ranks(a, masks)}
  for orient, rows in (("t2v", ref), ("v2t", ref.T)):
    got, want = ranks[orient](sims), ranks[orient](ref)
    worst, frac, same_inf = rank_agreement(torch, got, want)
    g = rows.gather(1, gt[:, None])
    slack = ((rows - g).abs() <= 2 * d).sum(1) - 1
    explained = bool(((got - want).abs() <= slack).all())
    print(f"  tp eval {orient} ranks vs single device: worst rank diff "
          f"{worst} on {frac:.3e} of queries (the 1 / 1e-3 rule "
          f"{'met' if worst <= 1 and frac < 1e-3 else 'NOT met'}); every "
          f"difference within the candidates that lie within 2 x {d:.0e} "
          f"of the GT: {explained} (at most "
          f"{int(slack.max())} such candidates); same inf positions "
          f"{same_inf}", flush=True)
    if not explained or not same_inf:
      raise RuntimeError(f"tp eval {orient}: ranks differ beyond the "
                         "rounding of the sims")


def tp_phase(torch, parallel, ranking, ref_sims, step_ref, dev, card):
  """The tensor-parallel eval and train step on two gloo ranks sharing the
  card, against the slice phase's kernel-path sims and the train-step
  phase's kernel step.  Returns the launches of B6 (per eval) and B7 (per
  step) on rank 0."""
  tic = time.perf_counter()
  results = parallel.spawn(tp_rank, TP_SIZE, "cuda", False, TP_EVAL_VIDEOS,
                           timeout=TP_TIMEOUT)
  print(f"tp: {TP_SIZE} gloo ranks sharing one card ran in "
        f"{time.perf_counter() - tic:.1f} s", flush=True)
  check_tp_launches(results)

  sims = [torch.from_numpy(r["sims"]).to(dev) for r in results]
  if not torch.equal(sims[0], sims[1]):
    raise RuntimeError("tp eval: the ranks' sims differ")
  if not bool(torch.isfinite(sims[0]).all()):
    raise RuntimeError("tp eval: non-finite sims")
  diff = float((sims[0] - ref_sims).abs().max())
  print(f"tp eval {TP_EVAL_VIDEOS} x {TP_EVAL_VIDEOS}: sims vs the slice "
        f"phase's kernel path max_abs_diff={diff:.3e} (limit "
        f"{TP_SIMS_TOL:.0e}; the sims' spread: std {float(ref_sims.std()):.3e}"
        f", range {float(ref_sims.max() - ref_sims.min()):.3e})", flush=True)
  if diff > TP_SIMS_TOL:
    raise RuntimeError(f"tp eval sims differ by {diff} > {TP_SIMS_TOL}")
  check_tp_ranks(torch, ranking, sims[0], ref_sims)

  loss_ref, grads_ref = step_ref
  for rank, r in enumerate(results):
    if not abs(r["loss"] - loss_ref) <= STEP_LOSS_TOL:
      raise RuntimeError(f"tp rank {rank} loss {r['loss']} vs {loss_ref}")
  check_step(torch, "tp train step vs single-device kernel step",
             results[0]["loss"], loss_ref,
             {n: torch.from_numpy(g) for n, g in results[0]["grads"].items()},
             grads_ref)
  a, b = (r["replicated"] for r in results)
  same = [n for n in a if a[n] == b.get(n)]
  print(f"tp: after 3 steps {len(same)} of {len(a)} replicated parameters "
        "and buffers bitwise equal on both ranks", flush=True)
  if len(same) != len(a) or set(a) != set(b):
    raise RuntimeError("tp: replicated parameters differ across ranks: "
                       f"{sorted(set(a) - set(same))[:5]}")
  for what in ("eval", "step"):
    runs = [[round(x, 6) for x in r[f"{what}_wall_s"]] for r in results]
    wall = statistics.median(results[0][f"{what}_wall_s"])
    reduce_s = results[0]["reduce_s"]
    in_reduces = sum(n * reduce_s[shape] for shape, n in TP_REDUCES[what])
    print(f"tp {what} wall (two gloo ranks sharing one card, per rank): "
          f"{runs}; median rank 0 {wall:.6f} s, of which its "
          f"{sum(n for _, n in TP_REDUCES[what])} all-reduces take about "
          f"{in_reduces:.6f} s (" + ", ".join(
              f"{n} x {list(shape)} at {reduce_s[shape] * 1e3:.3f} ms"
              for shape, n in TP_REDUCES[what]) + f") card: {card}",
          flush=True)
  return {"ffn_partial": results[0]["eval_launches"]["ffn_partial"],
          "ffn_train_fwd_partial":
              results[0]["step_launches"]["ffn_train_fwd_partial"]}


# Kernels of the eval block B1 (csrc/ffn_block.cu): the GEMM route's
# cast, two GEMMs and LayerNorm row pass, and the WMMA kernel of other
# widths.  Names as the profiler reports them contain these.
B1_KERNELS = ("ffn_cast_bf16_kernel", "ffn_tn_gemm_kernel",
              "ffn_ln_rows_kernel", "ffn_block_bf16_kernel")
PROFILE_TOP = 10


def profile_phase(torch, evaluate, ffn, model, batches, alone, card):
  """One eval-1k on the kernel path under torch.profiler: device time,
  wall, the top device operations, B1's total in situ against its
  kernel-phase time alone times its launches, the device activities
  (kernels and copies) launched, and the device's idle share of the
  wall (one stream, so kernel times add)."""
  from torch.profiler import ProfilerActivity, profile

  evaluate.retrieval_eval(model, batches)        # warm-up
  torch.cuda.synchronize()
  ffn.ffn_block_cuda.launches = 0
  with profile(activities=[ProfilerActivity.CPU,
                           ProfilerActivity.CUDA]) as prof:
    tic = time.perf_counter()
    evaluate.retrieval_eval(model, batches)
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - tic) * 1e3
  b1_launches = ffn.ffn_block_cuda.launches
  events = prof.key_averages()
  dev_us = lambda e: e.self_device_time_total
  dev = sorted(device_events(prof), key=dev_us, reverse=True)
  total_ms = sum(map(dev_us, dev)) / 1e3
  n_dev = sum(e.count for e in dev)
  host_ms = sum(e.self_cpu_time_total for e in events) / 1e3
  b1 = [e for e in dev if any(k in e.key for k in B1_KERNELS)]
  b1_ms = sum(map(dev_us, b1)) / 1e3
  # 20 chunks: 4 video blocks of 10,900 x 512 and 12 text blocks of
  # 1,500 x 768 each; alone[shape] is (event ms, device ms) of one call.
  chunks = N_VIDEOS // CHUNK
  alone_ms = [chunks * (4 * alone[(10900, 512)][k]
                        + 12 * alone[(1500, 768)][k]) for k in (0, 1)]
  if not total_ms > 0:
    raise RuntimeError("the profiler recorded no device time")
  print(f"profile: eval 1k x 1k on the kernel path, wall {wall_ms:.3f} ms "
        f"(under the profiler), device time {total_ms:.3f} ms in {n_dev} "
        f"device activities, host self time {host_ms:.3f} ms, device idle "
        f"share {1 - total_ms / wall_ms:.4f} card: {card}", flush=True)
  print(f"profile: B1 in situ {b1_ms:.3f} ms ({b1_ms / total_ms:.2%} of "
        f"device time; {b1_launches} launches, "
        f"{sum(e.count for e in b1)} kernels) against the kernel phase's "
        f"time alone x launches: CUDA events {alone_ms[0]:.3f} ms (in situ "
        f"/ alone {b1_ms / alone_ms[0]:.4f}), device time {alone_ms[1]:.3f} "
        f"ms ({b1_ms / alone_ms[1]:.4f})", flush=True)
  for e in b1:
    print(f"  B1 kernel {dev_us(e) / 1e3:.3f} ms x{e.count} {e.key[:110]}",
          flush=True)
  for e in dev[:PROFILE_TOP]:
    share = dev_us(e) / 1e3 / total_ms
    print(f"  top device op {dev_us(e) / 1e3:.3f} ms ({share:.2%}) "
          f"x{e.count} {e.key[:110]}", flush=True)
  if b1_launches != FFN_LAYERS * chunks:
    raise RuntimeError(f"profiled eval launched B1 {b1_launches} times")


class PhaseClock:
  """Seconds of each phase: ``done(name)`` ends the phase that began at
  the last call (or at construction) and prints its seconds."""

  def __init__(self):
    self.start = self.last = time.perf_counter()
    self.seconds = {}

  def done(self, name):
    now = time.perf_counter()
    self.seconds[name] = now - self.last
    self.last = now
    print(f"phase {name}: {self.seconds[name]:.1f} s", flush=True)

  def total(self):
    return time.perf_counter() - self.start


def finite_metrics(res):
  for which in ("t2v_metrics", "v2t_metrics"):
    vals = [res[which][k] for k in ("R1", "R5", "R10", "R50", "MedR",
                                    "MeanR", "geometric_mean_R1-R5-R10")]
    if not all(map(lambda x: x == x and abs(x) != float("inf"), vals)):
      raise RuntimeError(f"non-finite {which}: {vals}")


def main():
  import torch

  if not torch.cuda.is_available():
    print("chip_smoke: no CUDA device; nothing was run", file=sys.stderr)
    return 1
  torch.backends.cuda.matmul.allow_tf32 = False
  torch.backends.cudnn.allow_tf32 = False
  from mmt_tpu_torch import _build, bench, evaluate, flagship, ops, parallel
  from mmt_tpu_torch.ops import dropout, ffn, ranking, similarity
  from mmt_tpu_torch.train import metrics

  clock = PhaseClock()

  card = bench.card_line()
  print(f"card: {card}", flush=True)
  print(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"device {torch.cuda.get_device_name(0)}", flush=True)

  tic = time.perf_counter()
  lib_path = _build.build()
  _build.load_library()
  print(f"build: {lib_path.name} in {time.perf_counter() - tic:.1f} s",
        flush=True)
  for line in (lib_path.parent / "build.log").read_text().splitlines():
    if "Compiling entry function" in line:
      print(f"  ptxas: {line.split(chr(39))[1]}")
    elif "registers" in line or "spill" in line:
      print(f"  ptxas:   {line.strip()}")
  clock.done("build")

  dev = torch.device("cuda", 0)
  gen = torch.Generator(device=dev).manual_seed(0)
  ffn_entry, alone = ffn_phase(torch, ops, ffn, dev, gen, card)
  entries = {"ffn_block": ffn_entry,
             "moe_similarity": sim_phase(torch, similarity, dev, gen, card)}
  clock.done("kernel")
  rank_err = rank_kernel_phase(torch, ranking, similarity, dev, gen, card)
  clock.done("rank-kernel")
  train_entries, train_alone = train_kernel_phase(torch, ffn, dropout, dev,
                                                  gen, card)
  entries.update(train_entries)
  clock.done("train-kernel")
  entries.update(partial_kernel_phase(torch, ffn, dropout, dev, gen, card))
  clock.done("partial-kernel")
  reference_phase(torch, flagship, evaluate, dev)
  clock.done("reference")

  # ---- slice phase: the full-width flagship, 1k x 1k ----
  tic = time.perf_counter()
  model, batches = bench.staged_flagship(dev)
  torch.cuda.synchronize()
  print(f"slice: flagship CENet bf16, {N_VIDEOS} videos in "
        f"{len(batches)} chunks of {CHUNK} (model and inputs made in "
        f"{time.perf_counter() - tic:.1f} s)", flush=True)

  ffn.ffn_block_cuda.launches = 0
  similarity.sim_cuda.launches = 0
  res = evaluate.retrieval_eval(model, batches)
  torch.cuda.synchronize()
  launches = {"ffn_block": ffn.ffn_block_cuda.launches,
              "moe_similarity": similarity.sim_cuda.launches}
  print(f"slice launches: {launches}", flush=True)
  want_ffn = FFN_LAYERS * (N_VIDEOS // CHUNK)
  if launches["ffn_block"] != want_ffn or launches["moe_similarity"] < 1:
    raise RuntimeError(f"expected {want_ffn} ffn_block and >= 1 "
                       f"moe_similarity launches, got {launches}")
  sims = res["sims"]
  if tuple(sims.shape) != (N_VIDEOS, N_VIDEOS):
    raise RuntimeError(f"sims shape {tuple(sims.shape)}")
  if not bool(torch.isfinite(sims).all()):
    raise RuntimeError("non-finite sims")
  finite_metrics(res)
  for which in ("t2v_metrics", "v2t_metrics"):
    shown = {k: v for k, v in res[which].items() if k != "cols"}
    print(f"slice {which}: {json.dumps(shown)}", flush=True)

  with ops.plain_versions():
    res_plain = evaluate.retrieval_eval(model, batches)
  torch.cuda.synchronize()
  diff = float((res_plain["sims"] - sims).abs().max())
  print(f"slice: kernel vs plain sims max_abs_diff={diff:.3e}", flush=True)
  if diff > 2e-2:
    raise RuntimeError(f"kernel vs plain sims differ by {diff} > 2e-2")
  if ffn.ffn_block_cuda.launches != want_ffn:
    raise RuntimeError("the plain run launched the FFN kernel")

  def wall(plain):
    torch.cuda.synchronize()
    tic = time.perf_counter()
    if plain:
      with ops.plain_versions():
        evaluate.retrieval_eval(model, batches)
    else:
      evaluate.retrieval_eval(model, batches)
    torch.cuda.synchronize()
    return time.perf_counter() - tic

  wall(False)
  wall(True)
  runs = {False: [], True: []}
  for _ in range(5):
    for plain in (False, True):
      runs[plain].append(wall(plain))
  k_s, p_s = statistics.median(runs[False]), statistics.median(runs[True])
  print(f"eval 1k x 1k wall (median of 5): kernel_path_s={k_s:.6f} "
        f"plain_path_s={p_s:.6f} ratio={k_s / p_s:.4f} "
        f"videos_per_s={N_VIDEOS / k_s:.1f} card: {card}", flush=True)
  print(f"eval runs kernel_path_s={[round(x, 6) for x in runs[False]]} "
        f"plain_path_s={[round(x, 6) for x in runs[True]]}", flush=True)
  del res, res_plain
  clock.done("slice")
  profile_phase(torch, evaluate, ffn, model, batches, alone, card)
  clock.done("profile")

  # ---- at-scale phase: the fused eval at 20k videos, no matrix ----
  entries["fused_ranks"] = at_scale_phase(
      torch, (bench, evaluate, metrics, ops, ffn, similarity, ranking),
      model, batches, dev, card)
  entries["fused_ranks"]["max_abs_err"] = max(
      rank_err, entries["fused_ranks"]["max_abs_err"])
  del model, batches
  torch.cuda.empty_cache()
  clock.done("at-scale")

  train_launches, *step_ref, step = train_step_phase(
      torch, flagship, ops, ffn, similarity, dev, card)
  clock.done("train-step")
  train_profile_phase(torch, ffn, dropout, step, train_alone, dev, gen, card)
  del step
  torch.cuda.empty_cache()
  clock.done("train-profile")
  tp_launches = tp_phase(torch, parallel, ranking, sims, step_ref, dev, card)
  del sims, step_ref
  clock.done("tp")
  entries["ffn_block"]["launches"] = launches["ffn_block"]
  entries["moe_similarity"]["launches"] = launches["moe_similarity"]
  for name in ("ffn_train_fwd", "ffn_train_bwd"):
    entries[name]["launches"] = train_launches[name]
  for name, n in tp_launches.items():
    entries[name]["launches"] = n
  shown = {k: round(v, 1) for k, v in clock.seconds.items()}
  print(f"phases (s): {json.dumps(shown)}; total {clock.total():.1f} s",
        flush=True)

  print(f"card: {card}")
  print(json.dumps({"kernels": [
      {"name": name, "route": "cuda", "source": f"mmt_tpu_torch/csrc/{src}",
       "replaces": replaces, **entries[name]}
      for name, src, replaces in (
          ("ffn_block", "ffn_block.cu", "mmt_tpu/ops/ffn.py:119"),
          ("moe_similarity", "moe_similarity.cu",
           "mmt_tpu/ops/similarity.py:244"),
          ("ffn_train_fwd", "ffn_block.cu", "mmt_tpu/ops/ffn.py:477"),
          ("ffn_train_bwd", "ffn_train_bwd.cu", "mmt_tpu/ops/ffn.py:499"),
          ("fused_ranks", "fused_ranks.cu", "mmt_tpu/ops/ranking.py:101"),
          ("ffn_partial", "ffn_block.cu", "mmt_tpu/ops/ffn.py:369"),
          ("ffn_train_fwd_partial", "ffn_block.cu",
           "mmt_tpu/ops/ffn.py:576"))]}))
  print(json.dumps({"ok": True, "device": {
      "platform": "gpu", "kind": torch.cuda.get_device_name(0),
      "count": torch.cuda.device_count()}}))
  return 0


if __name__ == "__main__":
  sys.exit(main())
