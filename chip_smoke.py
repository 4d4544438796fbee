#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (mmt_tpu_torch) once on one NVIDIA GPU.

  python3 chip_smoke.py          # from the repository root, one card

Phases, each of which raises (exit code 1, no final line) on failure:

1. Build the CUDA kernels from mmt_tpu_torch/csrc/ with nvcc (sm_90a),
   one nvcc process per source, all at once; then the host libraries of
   the loader's native path (mmt_tpu_torch/native/assembler.cc and
   wordpiece.cc) with $CXX (default g++).
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
11. Train-CLI phase: ``mmt_tpu_torch.cli`` (the port of train.py) trains
   the flagship config (bf16, b32, the loaders' own num_workers) on a
   synthetic MSRVTT cut-c corpus written by the port's
   ``synthetic.generate`` at the flagship's 7 experts and widths (1,000
   train and 32 val videos, up to 30 feature rows, 3 captions; the
   vocab padded to bert-base-cased's 28,996 entries) through the real
   loader and its CUDA prefetch: 2 epochs of 8 steps with a continuous
   eval of the 1,000 train videos after each (and before the first), a
   restart to 3 epochs, then ``--only_eval --resume`` on the plain
   versions.  Launches exactly 16 B1 per eval batch, 16 B2 and 16 B3
   per step, one B4 per step and per eval; n_steps 16 then 24; finite
   epoch losses; the checkpoints and artifacts written; the final sims
   within 2e-2 of the plain versions'.  Prints the loop's median
   data-loading, step and total ms (the trainer's timers) against phase
   8's staged b32 step, and each 1,000-video eval's embed / similarity
   / metrics seconds and videos/s against phase 6's staged eval-1k.
   The loader runs its default, native path (the C++ assembler and
   WordPiece fast path): before the runs, one train and one eval batch
   from the same seed (``num_workers=0``) must be bitwise equal on the
   native and the Python path; after them the loop's data loading,
   window mean and median step and eval-1k through the loader are
   printed beside run D, the recorded Python-path run (PERF.md, RUN_D
   below).  The 2-epoch run is
   made twice more, with the same launch counts: on the Python path
   (``MMT_TPU_NATIVE_ASSEMBLY=0``, ``MMT_TPU_DISABLE_NATIVE=1``) and on
   the native path with ``"async_checkpoint": false``; each run's
   tokenizer must have taken only its own path.  The three runs' loop
   numbers (epoch 2's first three steps among them) are printed side by
   side, with native / Python in this call.
   (d) The pretrained text-tower init: a synthetic asset under HF
   BertForPreTraining names at bert-base-cased's geometry (197 tensors,
   107,719,680 parameters, 431 MB fp32, plus the pooler, position_ids and
   cls.* heads to drop), written as pytorch_model.bin and converted by
   ``python -m mmt_tpu_torch.hf_bert``; then through ``cli.main`` on the
   phase's corpus and config: ``--only_eval --txt_bert_init`` (every
   txt_bert parameter bitwise the asset's; 16 B1 per eval batch, 1 B4),
   one epoch from the init (finite losses; launches as counted above),
   and ``--only_eval --load_checkpoint <that run's checkpoint>
   --txt_bert_init <a zero asset>`` (every entry the checkpoint's: the
   checkpoint wins).  Prints the asset's load and merge seconds.
   (e) Before the CLI runs, on the card's host alone:
   ``mmt_tpu_torch.bench_loader``'s protocol (the flagship's 7 experts
   at their widths, b32, 30 of up to 40 rows, 200 videos): train and
   eval samples/s at 0, 1, 2 and 8 workers, Python and native path,
   cold and warm record cache; the tokenizer's texts/s on the corpus's
   captions and on serving's query strings (native ids equal to the
   Python path's); the host's cores and thread pools.
12. Serve phase, in three parts.  (a) Before phase 11's directory is
   removed, ``mmt_tpu_torch.serve.main`` on its trained_model.pth and
   config: --build_index over the eval set (32 videos) with 4 --query
   captions, exact, then --quantize int8 from the saved .npz index;
   launches exactly 4 B1 per video batch of the build, 12 B1 and 1 B4
   per exact query batch, 12 B1 and 0 B4 per int8 one; the hits
   well-formed (ids of the index, ``topk`` of them, scores not
   increasing).  (b) The full-width flagship (bf16, random weights from
   a seed) serving a synthetic index of 100,000 videos x 7 x 512
   (L2-normalised rows, L1 weights; 1.43 GB fp32, 0.36 GB int8), exact
   then int8: the launch counts of a query batch of 1 and of 64; on the
   exact engine the kernel path's top-10 of 64 queries against the
   plain versions' (scores within 2e-2; an id in one top-10 only must
   have a plain score within 2e-2 of the plain 10th); ``serve_http``
   traffic, interactive (200 GETs of 1 query, topk 5) and bulk (50 POSTs
   of 64, topk 10), each on a fresh server: its /statz p50/p90/p99 and
   the client's p50/p99; one query batch of 1 and of 64 under
   torch.profiler (wall, device time, idle share, split into B1, B4,
   B4's k-major scratch fill, the top-k and the rest); int8's overlap@10
   with exact; the pinned int8 rule of tests/test_serving.py (R@1/5/10
   identical, top-1 identical on >= 99%, overlap@10 >= 0.95, top-k score
   MAE <= 1e-3) on its planted corpus (512 x 64), and all of it but R@K
   equality on the 10,000 x 1,000 one.  (c) B1 at the serving text rows
   (30 and 1,920 x 768; phase 1's bf16 rules, both row tiles bitwise
   equal) and B4 at [1, 1,000], [1, 100,000] and [64, 100,000] (1e-5;
   with its scratch fill's device time) against their plain versions,
   in CUDA-event and device ms, B4 beside the fp32 ``torch.mm`` of its
   numerator; these are the ``serving_shapes`` of the ``ffn_block`` and
   ``moe_similarity`` entries of the kernel line, whose
   ``serving_launches`` are (a)'s counts.

Each phase prints its seconds, and the run its total.  The last two
lines of stdout are one JSON object of kernel results (each kernel's
launches on its main path, worst disagreement, times, bound and library
time) and {"ok": true, "device": {...}}; the card's name and power limit
come on the line before them.
"""

from __future__ import annotations

import contextlib
import io
import itertools
import json
import logging
import math
import os
import pathlib
import shutil
import statistics
import subprocess
import sys
import time

N_VIDEOS, CHUNK = 1000, 50
TEXT_LAYERS, VIDEO_LAYERS = 12, 4   # one FFN block each
FFN_LAYERS = TEXT_LAYERS + VIDEO_LAYERS


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


PROFILE_TRIES = 4


def device_split(torch, fn, reps=20):
  """{device activity: its device ms in one call} under torch.profiler
  over ``reps`` calls after a warm-up: each activity's mean time times the
  number of times one call runs it (its count over ``reps``, at least 1).

  On the H100 a session now and then misses device activities: the last
  one of the session (counts such as [20, 20, 20, 19] over 20 calls), or,
  late in a long process, all but those of the first call or two.  The
  mean of the activities recorded is kept whole by that; a sum over the
  session divided by ``reps`` would read low.  A session that recorded no
  device activity at all is run again, up to PROFILE_TRIES times; then
  this raises."""
  from torch.profiler import ProfilerActivity, profile

  fn()
  torch.cuda.synchronize()
  for _ in range(PROFILE_TRIES):
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
      for _ in range(reps):
        fn()
      torch.cuda.synchronize()
    events = device_events(prof)
    if events:
      return {e.key: e.self_device_time_total / 1e3 / e.count
              * max(1, round(e.count / reps)) for e in events}
    print("  profiler session recorded no device activity: run again",
          flush=True)
  raise RuntimeError(f"the profiler recorded no device activity in "
                     f"{PROFILE_TRIES} sessions")


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
  """Each FFN case: kernel vs plain version, at the eval shapes of the
  staged eval-1k and of the train CLI's evals (phase 11, its ragged last
  batch included); returns the kernel's line entries (the bf16 cases'
  worst error, and the video-shape bf16 times and bound: no single
  PyTorch call computes the block) and the bf16 kernel time of each
  (rows, H)."""
  cases = [(10900, 512, 3072, torch.bfloat16), (1500, 768, 3072,
                                                torch.bfloat16),
           (1013, 768, 3072, torch.bfloat16),
           (1013, 192, 768, torch.bfloat16),   # off the GEMM route: WMMA
           # The train CLI's evals (phase 11): b32 video and text, and the
           # last batch of 8 of 1,000 videos (64-row tile at H = 512).
           (6976, 512, 3072, torch.bfloat16), (960, 768, 3072,
                                               torch.bfloat16),
           (1744, 512, 3072, torch.bfloat16), (240, 768, 3072,
                                               torch.bfloat16),
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
    if ffn.gemm_route(h, i, cd):
      sms = torch.cuda.get_device_properties(dev).multi_processor_count
      route += f", {ffn.GEMM_TILES[ffn.pick_gemm_tile(r, h, sms)]}-row tile"
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
  Returns the launch counts of the counted step, the kernel path's b32
  step time in ms (for the train-CLI phase), its loss and gradients (on
  the CPU) for the tensor-parallel phase, and ``step(batch_size, seed)``,
  one more kernel-path step of the timed run, for the train profile."""
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
  return (launches, times[TRAIN_BATCH][0], loss_k, grads_k,
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


# Phase 11: the flagship trained through the port's CLI and real loader.
CLI_TRAIN_VIDEOS, CLI_VAL_VIDEOS = 1000, 32   # cut c: train 1,000, val 32
CLI_MAX_FEATS, CLI_CAPTIONS = 30, 3
CLI_VOCAB = 28996                             # bert-base-cased's table
CLI_SAMPLES_PER_EPOCH = 256                   # 8 steps of b32 an epoch
CLI_CORPUS_LIMIT_S = 60.0
FLAGSHIP_CONFIG = "configs/eccv20/msrvtt_jsfusion_trainval.json"
# The pickle layout files these as "<name>_c" (the challenge's experts);
# phase 11 reads them under the flagship's names, so all 7 are read.
CLI_CHALLENGE_NAMED = ("face", "ocr", "scene", "speech")
CLI_COUNTED = {"ffn_block": "ffn_block_cuda",
               "ffn_train_fwd": "ffn_train_fwd_cuda",
               "ffn_train_bwd": "ffn_train_bwd_cuda"}


# Phase 11 (e) and the real loop against run D, the recorded run of
# phase 11 on the Python path (H100 80GB HBM3, 700.00 W; PERF.md).
RUN_D = {"window_ms": 377.012, "median_ms": 173.112,
         "data_loading_ms": 40.763, "eval_s": 3.8675}
LOADER_BENCH_ARGV = []              # mmt_tpu_torch.bench_loader's defaults
LOADER_BENCH_LIMIT_S = 60.0
EPOCH2_STEPS = 3                    # epoch 2's first steps, printed


def loader_bench_phase(card):
  """Phase 11 (e): ``python -m mmt_tpu_torch.bench_loader`` on the card's
  host (no card work).  Returns its result."""
  from mmt_tpu_torch import bench_loader

  tic = time.perf_counter()
  res = bench_loader.run(bench_loader.parse_args(LOADER_BENCH_ARGV),
                         out=lambda line: print(f"{line} card: {card}",
                                                flush=True))
  sec = time.perf_counter() - tic
  rows = {(r["mode"], r["workers"], r["path"]): r for r in res["loader"]}
  for (mode, workers, path), r in sorted(rows.items()):
    if path == "native":
      py = rows[(mode, workers, "python")]
      print(f"loader bench: {mode} workers={workers} native / python: "
            f"cold {r['cold'] / py['cold']:.3f}x, warm "
            f"{r['warm'] / py['warm']:.3f}x card: {card}", flush=True)
  print(f"loader bench: {json.dumps(res)}", flush=True)
  print(f"loader bench: {sec:.1f} s", flush=True)
  if sec > LOADER_BENCH_LIMIT_S:
    print(f"loader bench: took over {LOADER_BENCH_LIMIT_S:.0f} s",
          flush=True)
  return res


def loader_paths_equal(cfg, dims, vocab):
  """One train and one eval batch of the config's loaders from the same
  seed, ``num_workers=0``, on the native and the Python path: every
  array bitwise equal, or raise."""
  import numpy as np

  from mmt_tpu_torch import bench_loader
  from mmt_tpu_torch.data import native_assembler as nasm
  from mmt_tpu_torch.data.loader import ExpertDataLoader

  toks = bench_loader.tokenizers(vocab)
  for key, training in (("train_sets", True),
                        ("continuous_eval_sets", False)):
    args = cfg[key][0]["args"]
    got = {}
    for path in ("python", "native"):
      nasm.set_enabled(path == "native")
      try:
        np.random.seed(0)
        ldr = ExpertDataLoader(mix=args["mix"], num_workers=0,
                               batch_size=args["batch_size"],
                               raw_input_dims=dims, training=training,
                               tokenizer=toks[path], loaded_data={})
        got[path] = next(iter(ldr["loader"]))
      finally:
        nasm.set_enabled(None)
    arrays = 0
    for name, want in got["python"].items():
      have = got["native"][name]
      pairs = ([(f"{name}/{m}", want[m], have[m]) for m in want]
               if isinstance(want, dict) else [(name, want, have)])
      for what, a, b in pairs:
        if isinstance(a, np.ndarray):
          arrays += 1
          if a.dtype != b.dtype or not np.array_equal(a, b):
            raise RuntimeError(f"train-cli: {key} batch, {what}: the native "
                               "path differs from the Python path")
    print(f"train-cli: {key} first batch (b{args['batch_size']}, "
          f"num_workers 0): native and Python path bitwise equal in all "
          f"{arrays} arrays", flush=True)


def check_tokenizer_path(trainer, native, what):
  """The run's tokenizer took only the path it was meant to."""
  texts = trainer.tokenizer.texts
  if texts["python" if native else "native"] or not sum(texts.values()):
    raise RuntimeError(f"train-cli {what}: the tokenizer's texts by path "
                       f"{texts}")


def loop_summary(seen, step0, eval0, steps):
  """One 2-epoch run's loop numbers from the trainer's timers: its
  ``steps`` step timers from ``step0`` and its 3 continuous evals from
  ``eval0``."""
  ms = {k: [x * 1e3 for x in seen[f"train_batch.{k}"][step0:step0 + steps]]
        for k in ("data_loading", "total")}
  per_epoch = CLI_SAMPLES_PER_EPOCH // 32
  parts = [[seen[k][i] for k in ("valid.embds", "valid.conf_mat",
                                 "valid.metrics")]
           for i in range(eval0, eval0 + 3)]
  eval_s = statistics.median(sum(p) for p in parts)
  embed_sim = statistics.median(p[0] + p[1] for p in parts)
  return {"data_loading_ms": statistics.median(ms["data_loading"]),
          "window_ms": statistics.mean(ms["total"]),
          "median_ms": statistics.median(ms["total"]),
          "epoch2_ms": [round(x, 3) for x in
                        ms["total"][per_epoch:per_epoch + EPOCH2_STEPS]],
          "eval_s": eval_s, "videos_s": CLI_TRAIN_VIDEOS / embed_sim}


def cli_config(data_dir, save_dir, epochs):
  """The flagship config with only the data, splits, compute dtype,
  epochs, samples per epoch and save_dir changed."""
  with open(FLAGSHIP_CONFIG) as f:
    cfg = json.load(f)
  cfg["arch"]["args"]["compute_dtype"] = "bfloat16"
  for key, split, caps in (("train_sets", "trainval", None),
                           ("continuous_eval_sets", "train", 1),
                           ("final_eval_sets", "val", 1)):
    entry = cfg[key][0]
    cfg[key] = [entry]
    mix = entry["args"]["mix"][0]
    mix.update(data_dir=str(data_dir), cut_name="c", split_name=split)
    if caps is not None:
      mix["captions_per_video"] = caps
  cfg["trainer"].update(epochs=epochs, save_dir=str(save_dir),
                        max_samples_per_epoch=CLI_SAMPLES_PER_EPOCH)
  return cfg


def cli_counts(ffn, similarity):
  counts = {k: getattr(ffn, v).launches for k, v in CLI_COUNTED.items()}
  counts["moe_similarity"] = similarity.sim_cuda.launches
  return counts


def cli_run(ffn, similarity, argv, want, what):
  """cli.main(argv) with every counter set to 0 just before and read
  just after; the counts must be ``want``."""
  from mmt_tpu_torch import cli
  for name in list(CLI_COUNTED.values()):
    getattr(ffn, name).launches = 0
  similarity.sim_cuda.launches = 0
  tic = time.perf_counter()
  trainer = cli.main(argv)
  import torch
  torch.cuda.synchronize()
  wall = time.perf_counter() - tic
  got = cli_counts(ffn, similarity)
  print(f"train-cli {what}: {wall:.1f} s, n_steps {trainer.n_steps}, "
        f"launches {got}", flush=True)
  if got != want:
    raise RuntimeError(f"train-cli {what}: expected launches {want}, "
                       f"got {got}")
  return trainer


def cli_loop_breakdown(torch, trainer, card):
  """Where the loop's time goes, after the counted runs: the loaders
  alone (assembly + the CUDA prefetch, no model), then one train epoch
  and one 1,000-video eval of ``trainer`` under torch.profiler (device
  time, the device's idle share of the wall, the top device ops)."""
  import numpy as np
  from torch.profiler import ProfilerActivity, profile

  from mmt_tpu_torch.data import loader as loader_lib

  def all_experts_read(batches):
    """The batches, the first checked to hold every expert of the
    config: none read as missing."""
    for j, batch in enumerate(batches):
      if j == 0:
        ind = batch["features_ind"]
        absent = [m for m in ind if not bool(np.asarray(ind[m]).any())]
        if len(ind) != 7 or absent:
          raise RuntimeError(f"train-cli: the loader read {sorted(ind)}; "
                             f"absent from the first batch: {absent}")
      yield batch

  def drain(batches):
    torch.cuda.synchronize()
    tic = time.perf_counter()
    n = sum(1 for _ in loader_lib.device_prefetch(batches, "cuda"))
    torch.cuda.synchronize()
    return n, time.perf_counter() - tic

  entry = trainer.data_loaders["continuous_eval_sets"][0]
  n, sec = drain(all_experts_read(iter(entry["loader"])))
  print(f"train-cli loader alone, eval: {n} batches ({CLI_TRAIN_VIDEOS} "
        f"videos, num_workers {entry['loader'].num_workers}) in {sec:.6f} s, "
        f"{CLI_TRAIN_VIDEOS / sec:.1f} videos/s card: {card}", flush=True)
  entry = trainer.data_loaders["train_sets"][0]
  steps = CLI_SAMPLES_PER_EPOCH // entry.batch_size
  n, sec = drain(itertools.islice(iter(entry["loader"]), steps))
  print(f"train-cli loader alone, train: {n} batches of {entry.batch_size} "
        f"in {sec:.6f} s, {sec * 1e3 / n:.3f} ms a batch card: {card}",
        flush=True)

  epoch = trainer.epochs + 1
  for what, run in (("train epoch", lambda: trainer._train_epoch(epoch)),
                    ("eval-1k", lambda: trainer._valid_epoch(epoch))):
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
      tic = time.perf_counter()
      run()
      torch.cuda.synchronize()
      wall_ms = (time.perf_counter() - tic) * 1e3
    dev_us = lambda e: e.self_device_time_total
    dev = sorted(device_events(prof), key=dev_us, reverse=True)
    total_ms = sum(map(dev_us, dev)) / 1e3
    if not total_ms > 0:
      raise RuntimeError("the profiler recorded no device time")
    print(f"train-cli profile, {what} through the loader: wall "
          f"{wall_ms:.3f} ms (under the profiler), device time "
          f"{total_ms:.3f} ms in {sum(e.count for e in dev)} device "
          f"activities, device idle share {1 - total_ms / wall_ms:.4f} "
          f"card: {card}", flush=True)
    for e in dev[:5]:
      print(f"  top device op {dev_us(e) / 1e3:.3f} ms "
            f"({dev_us(e) / 1e3 / total_ms:.2%}) x{e.count} {e.key[:110]}",
            flush=True)


def train_cli_phase(torch, ops, ffn, similarity, staged_step_ms,
                    staged_eval_s, card, then=None):
  """``mmt_tpu_torch.cli`` trains the full-width flagship (bf16) on a
  synthetic MSRVTT cut-c corpus at the flagship's 7 experts and real
  widths through the real loader: 2 epochs, then a restart with 3, then
  ``--only_eval --resume`` on the plain versions.  Checks the launches,
  counters, losses and artifacts; prints the loop's timers against the
  staged b32 step (phase 8) and eval-1k (phase 6).  ``then(cfg_path,
  exp)`` runs last, while the corpus, the experiment and the phase's
  environment still exist (phase 12 (a)).  Returns the launch counts of
  the first run and what ``then`` returned."""
  import signal
  import tempfile

  import numpy as np

  from mmt_tpu_torch import bench_loader
  from mmt_tpu_torch.data import datasets, synthetic
  from mmt_tpu_torch.data import native_assembler as nasm
  from mmt_tpu_torch.experts import compute_dims
  from mmt_tpu_torch.train import trainer as trainer_lib
  from mmt_tpu_torch.utils import timing

  class RecordingMeter(timing.AverageMeter):
    """The trainer's timers, also keeping every value (medians)."""
    seen = {}

    def update(self, key, val, n=1):
      super().update(key, val, n)
      RecordingMeter.seen.setdefault(key, []).append(val)

  root = pathlib.Path(tempfile.mkdtemp(prefix="mmt_train_cli_"))
  prev_sigterm = signal.getsignal(signal.SIGTERM)
  prev_meter = trainer_lib.AverageMeter
  prev_vocab = os.environ.get("MMT_TPU_BERT_VOCAB")
  prev_discover = datasets.discover_expert_paths

  def discover_as_flagship(data_dir):
    """The layout's expert files, the "*_c" ones under the config's
    names; every expert of the config must have the tables the model
    reads (the layout takes face-avg.pickle for face's fixed_seg)."""
    paths = prev_discover(data_dir)
    for mod in CLI_CHALLENGE_NAMED:
      if mod + "_c" in paths:
        paths[mod] = paths.pop(mod + "_c")
    missing = [m for m in dims
               if not {"fixed_seg", "max"} <= set(paths.get(m, ()))]
    if missing:
      raise RuntimeError(f"train-cli: no features for {missing}")
    return paths

  try:
    with open(FLAGSHIP_CONFIG) as f:
      dims = {m: d["dim"] for m, d in compute_dims(json.load(f)).items()}
    tic = time.perf_counter()
    data_dir = synthetic.generate(
        root, num_videos=CLI_TRAIN_VIDEOS + CLI_VAL_VIDEOS,
        num_test=CLI_VAL_VIDEOS, experts=dims,
        captions_per_video=CLI_CAPTIONS, max_feats=CLI_MAX_FEATS, cut="c")
    vocab = (root / "vocab.txt").read_text().splitlines()
    vocab += [f"[unused{i}]" for i in range(CLI_VOCAB - len(vocab))]
    (root / "vocab.txt").write_text("\n".join(vocab) + "\n")
    corpus_s = time.perf_counter() - tic
    size = sum(p.stat().st_size for p in data_dir.rglob("*")) / 2 ** 30
    print(f"train-cli: corpus of {CLI_TRAIN_VIDEOS + CLI_VAL_VIDEOS} videos "
          f"(cut c, {len(dims)} experts, {sum(dims.values())} floats a "
          f"row, up to {CLI_MAX_FEATS} rows, {CLI_CAPTIONS} captions) "
          f"written in {corpus_s:.1f} s, {size:.2f} GiB; vocab "
          f"{len(vocab)}", flush=True)
    if corpus_s > CLI_CORPUS_LIMIT_S:
      print(f"train-cli: writing the corpus took over "
            f"{CLI_CORPUS_LIMIT_S:.0f} s", flush=True)
    os.environ["MMT_TPU_BERT_VOCAB"] = str(root / "vocab.txt")
    trainer_lib.AverageMeter = RecordingMeter
    datasets.discover_expert_paths = discover_as_flagship
    exp = root / "exp"
    cfg_path = root / "flagship_c.json"
    cfg_path.write_text(json.dumps(cli_config(data_dir, exp, 2)))
    loader_paths_equal(cli_config(data_dir, exp, 2), dims,
                       root / "vocab.txt")

    per_eval = -(-CLI_TRAIN_VIDEOS // 32)        # 32 batches, the last 8
    final_batches = -(-CLI_VAL_VIDEOS // 32)

    def want(steps, evals, eval_batches):
      return {"ffn_block": FFN_LAYERS * eval_batches,
              "ffn_train_fwd": FFN_LAYERS * steps,
              "ffn_train_bwd": FFN_LAYERS * steps,
              "moe_similarity": steps + evals}

    # 2 epochs: continuous evals at epochs 0, 1, 2 and the final eval.
    steps = 2 * CLI_SAMPLES_PER_EPOCH // 32
    first = want(steps, 4, 3 * per_eval + final_batches)
    trainer = cli_run(ffn, similarity, ["--config", str(cfg_path),
                                        "--device", "cuda"],
                      first, "2 epochs")
    if trainer.n_steps != steps:
      raise RuntimeError(f"train-cli: n_steps {trainer.n_steps} != {steps}")
    for name in ("checkpoint-epoch2.pth", "trained_model.pth",
                 "exp_results.json", "exp_completed_flag.txt",
                 "MSRVTT-val-sims.npy", "perf_log.txt", "config.json"):
      if not (exp / name).exists():
        raise RuntimeError(f"train-cli: {name} missing")

    # Restart with 3 epochs: epoch 3 and its eval, then the final eval.
    cfg = json.loads((exp / "config.json").read_text())
    cfg["trainer"]["epochs"] = 3
    (exp / "config.json").write_text(json.dumps(cfg, indent=4))
    trainer = cli_run(ffn, similarity, ["--resume", str(exp),
                                        "--device", "cuda"],
                      want(steps // 2, 2, per_eval + final_batches),
                      "--resume to 3 epochs")
    if trainer.n_steps != steps * 3 // 2:
      raise RuntimeError(f"train-cli: n_steps {trainer.n_steps} after the "
                         f"restart != {steps * 3 // 2}")
    with open(exp / "perf_log.txt") as f:
      losses = [json.loads(line)["loss"] for line in f]
    print(f"train-cli: epoch losses {losses}", flush=True)
    if len(losses) != 4 or not all(math.isfinite(x) for x in losses):
      raise RuntimeError(f"train-cli: bad epoch losses {losses}")
    kernel_sims = np.load(exp / "MSRVTT-val-sims.npy",
                          allow_pickle=True)[()]["sims"]
    results = json.loads((exp / "exp_results.json").read_text())["perfs"]
    print(f"train-cli: final eval {json.dumps(results)}", flush=True)
    check_tokenizer_path(trainer, True, "--resume to 3 epochs")
    # The counted runs' timers, before the breakdown adds its own.
    seen = {k: list(v) for k, v in RecordingMeter.seen.items()}
    cli_loop_breakdown(torch, trainer, card)

    with ops.plain_versions():
      cli_run(ffn, similarity, ["--resume", str(exp), "--only_eval",
                                "--device", "cuda"],
              {k: 0 for k in first}, "--only_eval --resume, plain versions")
    plain_sims = np.load(exp / "MSRVTT-val-sims.npy",
                         allow_pickle=True)[()]["sims"]
    diff = float(np.abs(plain_sims - kernel_sims).max())
    print(f"train-cli: final sims kernel vs plain max_abs_diff={diff:.3e} "
          "(limit 2e-2)", flush=True)
    if not np.isfinite(kernel_sims).all() or diff > 2e-2:
      raise RuntimeError(f"train-cli: final sims differ by {diff} > 2e-2")

    ms = lambda key, runs: [round(x * 1e3, 3) for x in runs.get(key, [])]
    for key in ("train_batch.data_loading", "train_batch.step",
                "train_batch.total"):
      vals = seen[key]
      print(f"train-cli loop {key} (trainer timer, {len(vals)} steps): "
            f"median {statistics.median(vals) * 1e3:.3f} ms; all "
            f"{ms(key, seen)}", flush=True)
    # Sustained: the whole window, the stalls that open each epoch (the
    # loader's threads starting cold) included: one epoch in 8 steps here.
    steps_ms = [x * 1e3 for x in seen["train_batch.total"]]
    per_epoch = CLI_SAMPLES_PER_EPOCH // 32
    opening = steps_ms[::per_epoch]
    rest = [x for j, x in enumerate(steps_ms) if j % per_epoch]
    total = sum(steps_ms) / len(steps_ms)
    median = statistics.median(steps_ms)
    print(f"train-cli: sustained b32 step through the loader (whole "
          f"window: {sum(steps_ms):.3f} ms over {len(steps_ms)} steps) "
          f"{total:.3f} ms, samples/s {32e3 / total:.1f}; median "
          f"{median:.3f} ms, samples/s {32e3 / median:.1f}; the "
          f"{len(opening)} steps opening an epoch {statistics.mean(opening):.3f}"
          f" ms on average, the other {len(rest)} "
          f"{statistics.mean(rest):.3f}; against the staged b32 step "
          f"{staged_step_ms:.3f} ms (phase 8): whole window "
          f"{total / staged_step_ms:.4f}x, median "
          f"{median / staged_step_ms:.4f}x card: {card}", flush=True)
    # The eval timers in order: the first run's continuous evals (1,000
    # videos) at epochs 0-2 and its final eval (32), the restart's
    # continuous eval and final eval, the plain --only_eval's final eval.
    evals = [0, 1, 2, 4]
    parts = {k: [seen[k][i] for i in evals]
             for k in ("valid.embds", "valid.conf_mat", "valid.metrics")}
    for i in range(len(evals)):
      e, c, m = (parts[k][i] for k in parts)
      print(f"train-cli eval-1k through the loader #{i}: embed {e:.6f} s, "
            f"similarity {c:.6f} s, metrics {m:.6f} s; "
            f"{CLI_TRAIN_VIDEOS / (e + c):.1f} videos/s (embed + "
            "similarity)", flush=True)
    e, c, m = (statistics.median(parts[k]) for k in parts)
    print(f"train-cli: eval-1k through the loader (median of {len(evals)}) "
          f"embed {e:.6f} + similarity {c:.6f} + metrics {m:.6f} = "
          f"{e + c + m:.6f} s against the staged eval-1k "
          f"{staged_eval_s:.6f} s (phase 6, embed + similarity + ranks); "
          f"videos/s through the loader {CLI_TRAIN_VIDEOS / (e + c):.1f} "
          f"card: {card}", flush=True)
    loading = statistics.median(seen["train_batch.data_loading"]) * 1e3
    print(f"train-cli: the native path against run D (the Python path; "
          f"H100 80GB HBM3, 700.00 W): data_loading median "
          f"{loading:.3f} ms (run D {RUN_D['data_loading_ms']}); b32 step "
          f"window mean {total:.3f} ms (run D {RUN_D['window_ms']}), median "
          f"{median:.3f} (run D {RUN_D['median_ms']}), staged "
          f"{staged_step_ms:.3f}; eval-1k through the loader "
          f"{e + c + m:.6f} s, {CLI_TRAIN_VIDEOS / (e + c):.1f} videos/s "
          f"(run D {RUN_D['eval_s']} s), staged {staged_eval_s:.6f} s "
          f"card: {card}", flush=True)

    # Two more 2-epoch runs in this call, held to the same launches: the
    # Python path (the two switches) and the native path with the
    # checkpoint written inline (A14.3); each summarised as the first.
    runs = {"native path": loop_summary(seen, 0, 0, steps)}
    for what, native, async_ckpt in (
        ("Python path", False, True),
        ("native path, async_checkpoint false", True, False)):
      cfg = cli_config(data_dir, root / "exp_more", 2)
      cfg["trainer"]["async_checkpoint"] = async_ckpt
      (root / "flagship_c_more.json").write_text(json.dumps(cfg))
      at = {k: len(v) for k, v in RecordingMeter.seen.items()}
      path = (contextlib.nullcontext() if native
              else bench_loader.python_path())
      with path:
        if nasm.enabled() != native:
          raise RuntimeError(f"train-cli {what}: the assembler's path")
        more = cli_run(ffn, similarity, ["--config",
                                         str(root / "flagship_c_more.json"),
                                         "--device", "cuda"],
                       first, f"2 epochs, {what}")
      check_tokenizer_path(more, native, what)
      shutil.rmtree(root / "exp_more", ignore_errors=True)
      runs[what] = loop_summary(RecordingMeter.seen, at["train_batch.total"],
                                at["valid.embds"], steps)
    for what, r in runs.items():
      print(f"train-cli loop, {what} (2 epochs, {steps} steps): "
            f"data_loading median {r['data_loading_ms']:.3f} ms; b32 step "
            f"window mean {r['window_ms']:.3f} ms, median "
            f"{r['median_ms']:.3f}; epoch 2's first {EPOCH2_STEPS} steps "
            f"{r['epoch2_ms']} ms; eval-1k through the loader (median of "
            f"3) {r['eval_s']:.6f} s, {r['videos_s']:.1f} videos/s card: "
            f"{card}", flush=True)
    nat, py = runs["native path"], runs["Python path"]
    print("train-cli: native path / Python path in this call: "
          + ", ".join(f"{k} {nat[k] / py[k]:.4f}x" for k in
                      ("data_loading_ms", "window_ms", "median_ms", "eval_s"))
          + f" card: {card}", flush=True)
    txt_bert_init_phase(torch, ffn, similarity, root, data_dir, want,
                        per_eval, final_batches, card)
    return first, (then(cfg_path, exp) if then is not None else None)
  finally:
    trainer_lib.AverageMeter = prev_meter
    datasets.discover_expert_paths = prev_discover
    signal.signal(signal.SIGTERM, prev_sigterm)
    if prev_vocab is None:
      os.environ.pop("MMT_TPU_BERT_VOCAB", None)
    else:
      os.environ["MMT_TPU_BERT_VOCAB"] = prev_vocab
    shutil.rmtree(root, ignore_errors=True)


# Phase 11 (d): the pretrained text-tower init through the CLI.
INIT_SEED = 11


def hf_style_asset(torch, geom, seed=INIT_SEED):
  """Random weights under HF BertForPreTraining names at ``geom`` (a
  config.BertParams): the tower's 5 + 16 x layers tensors, then the
  position_ids buffer, the pooler and the cls.* heads that the conversion
  drops.  Returns (state dict, number of tower tensors)."""
  gen = torch.Generator().manual_seed(seed)
  h, inter = geom.hidden_size, geom.intermediate_size
  sd = {}

  def rand(*shape, scale=0.02, shift=0.0):
    return torch.randn(*shape, generator=gen) * scale + shift

  def lin(name, n_in, n_out):
    sd[f"{name}.weight"] = rand(n_out, n_in)
    sd[f"{name}.bias"] = rand(n_out, scale=0.01)

  def ln(name):
    sd[f"{name}.weight"] = rand(h, scale=0.01, shift=1.0)
    sd[f"{name}.bias"] = rand(h, scale=0.01)

  emb = "bert.embeddings"
  sd[f"{emb}.word_embeddings.weight"] = rand(geom.vocab_size, h)
  sd[f"{emb}.position_embeddings.weight"] = rand(
      geom.max_position_embeddings, h)
  sd[f"{emb}.token_type_embeddings.weight"] = rand(geom.type_vocab_size, h)
  ln(f"{emb}.LayerNorm")
  for layer in range(geom.num_hidden_layers):
    base = f"bert.encoder.layer.{layer}"
    for sub in ("attention.self.query", "attention.self.key",
                "attention.self.value", "attention.output.dense"):
      lin(f"{base}.{sub}", h, h)
    ln(f"{base}.attention.output.LayerNorm")
    lin(f"{base}.intermediate.dense", h, inter)
    lin(f"{base}.output.dense", inter, h)
    ln(f"{base}.output.LayerNorm")
  tower = len(sd)
  sd[f"{emb}.position_ids"] = torch.arange(geom.max_position_embeddings)[None]
  lin("bert.pooler.dense", h, h)
  lin("cls.predictions.transform.dense", h, h)
  ln("cls.predictions.transform.LayerNorm")
  sd["cls.predictions.bias"] = torch.zeros(geom.vocab_size)
  lin("cls.seq_relationship", h, 2)
  return sd, tower


def txt_bert_init_phase(torch, ffn, similarity, root, data_dir, want,
                        per_eval, final_batches, card):
  """Phase 11 (d): a synthetic HF asset at the config's text geometry
  (bert-base-cased), converted by hf_bert, then ``cli.main`` on phase
  11's corpus: --only_eval from the init (the tower bitwise the asset),
  one epoch from it, and --only_eval of that epoch's checkpoint over a
  zero init (the checkpoint wins).  Launches as counted; prints the
  asset's load and merge seconds."""
  import dataclasses

  from mmt_tpu_torch import hf_bert
  from mmt_tpu_torch.config import TEXT_BERT_BASE_CASED
  from mmt_tpu_torch.train import checkpoint as ckpt_lib
  from mmt_tpu_torch.train import trainer as trainer_lib

  start = time.perf_counter()

  def config(name, epochs):
    cfg = cli_config(data_dir, root / name, epochs)
    path = root / f"{name}.json"
    path.write_text(json.dumps(cfg))
    return cfg, path

  cfg, eval_cfg = config("init_eval", 1)
  vocab = len((root / "vocab.txt").read_text().splitlines())
  geom = dataclasses.replace(
      TEXT_BERT_BASE_CASED, **cfg["arch"]["args"].get("text_bert_geometry",
                                                      {}),
      vocab_size=vocab)
  tic = time.perf_counter()
  sd, tower = hf_style_asset(torch, geom)
  hf_dir = root / "hf_bert"
  hf_dir.mkdir()
  torch.save(sd, hf_dir / "pytorch_model.bin")
  written_s = time.perf_counter() - tic
  tic = time.perf_counter()
  asset_path = hf_bert.main(["--hf_dir", str(hf_dir),
                             "--out", str(root / "txt_bert_init.pth")])
  convert_s = time.perf_counter() - tic
  asset = ckpt_lib.load_txt_bert_init(asset_path)
  n_params = sum(t.numel() for t in asset.values())
  print(f"train-cli (d): HF asset of {len(sd)} tensors ({tower} of the "
        f"tower) written in {written_s:.3f} s; hf_bert kept {len(asset)} "
        f"tensors, {n_params:,} parameters, {n_params * 4 / 1e6:.1f} MB "
        f"fp32, in {convert_s:.3f} s", flush=True)
  if len(asset) != tower:
    raise RuntimeError(f"train-cli (d): hf_bert kept {len(asset)} tensors "
                       f"of the {tower} of the tower")
  del sd

  # 1. --only_eval from the init, its load and merge timed.
  seconds = {}
  load, merge = ckpt_lib.load_txt_bert_init, trainer_lib.Trainer._load_txt_bert_init

  def timed_load(path):
    tic = time.perf_counter()
    out = load(path)
    seconds["load"] = time.perf_counter() - tic
    return out

  def timed_merge(self, path):
    tic = time.perf_counter()
    merge(self, path)
    torch.cuda.synchronize()
    seconds["load + merge"] = time.perf_counter() - tic

  ckpt_lib.load_txt_bert_init = timed_load
  trainer_lib.Trainer._load_txt_bert_init = timed_merge
  try:
    trainer = cli_run(ffn, similarity, [
        "--config", str(eval_cfg), "--device", "cuda", "--only_eval",
        "--txt_bert_init", asset_path], want(0, 1, final_batches),
        "(d) --only_eval --txt_bert_init")
  finally:
    ckpt_lib.load_txt_bert_init = load
    trainer_lib.Trainer._load_txt_bert_init = merge
  differ = [n for n, p in trainer.model.txt_bert.named_parameters()
            if not torch.equal(p.detach().cpu(), asset[f"txt_bert.{n}"])]
  n_tower = sum(1 for _ in trainer.model.txt_bert.parameters())
  del trainer
  if differ or n_tower != len(asset):
    raise RuntimeError(f"train-cli (d): {len(differ)} of {n_tower} txt_bert "
                       f"parameters are not the asset's (first: "
                       f"{differ[:1]})")
  merge_s = seconds["load + merge"] - seconds["load"]
  print(f"train-cli (d): txt_bert init of {len(asset)} tensors "
        f"({n_params:,} parameters): load {seconds['load']:.3f} s, merge "
        f"{merge_s:.3f} s, load + merge {seconds['load + merge']:.3f} s; "
        f"every txt_bert parameter bitwise the asset's card: {card}",
        flush=True)

  # 2. One epoch from the init.
  _, train_cfg = config("init_train", 1)
  cli_run(ffn, similarity, ["--config", str(train_cfg), "--device", "cuda",
                            "--txt_bert_init", asset_path],
          want(CLI_SAMPLES_PER_EPOCH // 32, 3,
               2 * per_eval + final_batches),
          "(d) 1 epoch from the init")
  with open(root / "init_train" / "perf_log.txt") as f:
    losses = [json.loads(line)["loss"] for line in f]
  print(f"train-cli (d): epoch losses from the init {losses}", flush=True)
  if len(losses) != 2 or not all(math.isfinite(x) for x in losses):
    raise RuntimeError(f"train-cli (d): bad epoch losses {losses}")

  # 3. The checkpoint wins over a zero init.
  zero_path = root / "zero_init.pth"
  torch.save({"state_dict": {k: torch.zeros_like(v)
                             for k, v in asset.items()}}, zero_path)
  del asset
  ckpt = root / "init_train" / "trained_model.pth"
  _, warm_cfg = config("init_warm", 1)
  trainer = cli_run(ffn, similarity, [
      "--config", str(warm_cfg), "--device", "cuda", "--only_eval",
      "--load_checkpoint", str(ckpt), "--txt_bert_init", str(zero_path)],
      want(0, 1, final_batches), "(d) a checkpoint over a zero init")
  saved = ckpt_lib.load_checkpoint(ckpt)["state_dict"]
  state = trainer.model.state_dict()
  differ = [k for k, v in state.items()
            if not torch.equal(v.detach().cpu(), saved[k])]
  del trainer
  if differ or set(saved) != set(state):
    raise RuntimeError(f"train-cli (d): {len(differ)} entries differ from "
                       f"the checkpoint's (first: {differ[:1]})")
  print(f"train-cli (d): every entry the checkpoint's; phase 11 (d) "
        f"{time.perf_counter() - start:.1f} s", flush=True)
  for path in (hf_dir / "pytorch_model.bin", pathlib.Path(asset_path),
               zero_path):
    path.unlink()


# Phase 12: serving (mmt_tpu_torch.serving, mmt_tpu_torch.serve).
SERVE_CLI_QUERIES = ("a man is cooking pasta in a kitchen",
                     "a soccer match in the rain",
                     "a dog runs in the park",
                     "a woman sings a song on stage")
SERVE_VIDEOS, SERVE_M, SERVE_D = 100_000, 7, 512   # the flagship's geometry
SERVE_INTERACTIVE = (200, 1, 5)     # requests, queries a request, topk: GET
SERVE_BULK = (50, 64, 10)           # the same: POST
# Planted corpora (videos, queries): the pinned int8 rule's own, and the
# at-scale one of docs/SERVING.md (scripts/int8_quality.py's defaults).
SERVE_QUALITY_PINNED, SERVE_QUALITY = (512, 64), (10_000, 1_000)
SERVE_TOL = 2e-2                    # kernel path vs plain path, scores
SERVE_FFN_ROWS = (30, 1920)         # text rows of 1 and of 64 queries
SERVE_SIM_CASES = ((1, 1_000), (1, 100_000), (64, 100_000))
SERVE_WORDS = ("person cooking pasta kitchen soccer match goal rain city "
               "night dog park guitar song stage car road mountain beach "
               "man woman sings runs").split()
SERVE_SPLIT = {"B1": B1_KERNELS, "B4": ("moe_similarity_kernel",),
               "B4 scratch fill": ("k_major_kernel",),
               "top-k": ("topk", "TopK", "radix", "Radix", "sort", "Sort")}


def planted_corpus(num_videos, num_queries, modalities=7, dim=512, seed=0,
                   noise=0.35, weight_noise=0.1):
  """scripts/int8_quality.py:make_corpus (the same numpy draws): [N, M, D]
  L2-normalised video embeddings, L1-normalised weights, and queries
  that are noisy copies of a ground-truth video's (vid, vw, txt, tw,
  gt)."""
  import numpy as np

  rng = np.random.RandomState(seed)

  def l2norm(x):
    return x / np.maximum(np.linalg.norm(x, axis=-1, keepdims=True), 1e-12)

  def l1norm(w):
    return w / np.maximum(w.sum(-1, keepdims=True), 1e-12)

  vid = l2norm(rng.randn(num_videos, modalities, dim).astype(np.float32))
  vw = l1norm(np.abs(rng.randn(num_videos, modalities)).astype(np.float32))
  gt = rng.randint(0, num_videos, size=num_queries)
  txt = l2norm(vid[gt] + noise * rng.randn(num_queries, modalities, dim)
               .astype(np.float32))
  tw = l1norm(np.abs(vw[gt] + weight_noise
                     * rng.randn(num_queries, modalities)).astype(np.float32))
  return vid, vw, txt.astype(np.float32), tw.astype(np.float32), gt


def int8_quality(torch, serving, vid, vw, txt, tw, gt, device, topk=10,
                 batch=256):
  """scripts/int8_quality.py:quality_report through the port's engine
  tensors: the same query embeddings scored against the exact and the
  int8 staged index (``serving.stage_index`` / ``index_similarity``);
  R@1/5/10 of both, top-1 agreement, overlap@k, and the error of the
  int8 scores of each query's exact top-k videos."""
  import numpy as np

  staged = {q: serving.stage_index(vid, vw, device, q) for q in (None, "int8")}
  idx_f, idx_q, sc_f, sc_q = [], [], [], []
  with torch.inference_mode():
    for s in range(0, len(txt), batch):
      t = torch.from_numpy(txt[s:s + batch]).to(device)
      w = torch.from_numpy(tw[s:s + batch]).to(device)
      exact = serving.index_similarity(t, w, staged[None], len(vid))
      q8 = serving.index_similarity(t, w, staged["int8"], len(vid), "int8")
      scores_f, top_f = torch.topk(exact, topk)
      top_q = torch.topk(q8, topk)[1]
      idx_f.append(top_f.cpu().numpy())
      idx_q.append(top_q.cpu().numpy())
      sc_f.append(scores_f.cpu().numpy())
      sc_q.append(torch.gather(q8, 1, top_f).cpu().numpy())
  idx_f, idx_q = np.concatenate(idx_f), np.concatenate(idx_q)
  sc_f, sc_q = np.concatenate(sc_f), np.concatenate(sc_q)
  rep = {}
  for k in (1, 5, 10):
    k = min(k, topk)
    rep[f"R{k}_fp32"] = float((idx_f[:, :k] == gt[:, None]).any(1).mean())
    rep[f"R{k}_int8"] = float((idx_q[:, :k] == gt[:, None]).any(1).mean())
    rep[f"overlap@{k}"] = float(np.mean([
        len(set(idx_f[q, :k]) & set(idx_q[q, :k])) / k
        for q in range(len(gt))]))
  rep["top1_identical"] = float((idx_f[:, 0] == idx_q[:, 0]).mean())
  rep["score_mae_topk"] = float(np.abs(sc_f - sc_q).mean())
  rep["score_max_err_topk"] = float(np.abs(sc_f - sc_q).max())
  return rep


def int8_quality_faults(rep):
  """The pinned rule of tests/test_serving.py's int8 quality test, as a
  list of what ``rep`` (``int8_quality``'s) breaks: R@1/5/10 identical,
  top-1 identical on >= 99% of queries, overlap@10 >= 0.95, top-k score
  MAE <= 1e-3."""
  faults = [f"R{k}" for k in (1, 5, 10)
            if rep[f"R{k}_int8"] != rep[f"R{k}_fp32"]]
  if rep["top1_identical"] < 0.99:
    faults.append("top1_identical")
  if rep["overlap@10"] < 0.95:
    faults.append("overlap@10")
  if rep["score_mae_topk"] > 1e-3:
    faults.append("score_mae_topk")
  return faults


def check_hits(hits, topk, ids, what):
  """Each query's hits: ``topk`` of them, ids of the index, scores not
  increasing, ranks 0, 1, ...; raises otherwise."""
  for q, row in enumerate(hits):
    scores = [h["score"] for h in row]
    if (len(row) != topk or any(h["video_id"] not in ids for h in row)
        or scores != sorted(scores, reverse=True)
        or [h["rank"] for h in row] != list(range(topk))
        or not all(map(math.isfinite, scores))):
      raise RuntimeError(f"serve {what}: malformed hits for query {q}: "
                         f"{row}")


def serve_counted(torch, ffn, similarity, fn, want, what):
  """fn() with the B1 and B4 counters set to 0 just before and read just
  after; they must read ``want``.  Returns fn()'s result."""
  ffn.ffn_block_cuda.launches = 0
  similarity.sim_cuda.launches = 0
  tic = time.perf_counter()
  out = fn()
  torch.cuda.synchronize()
  got = {"ffn_block": ffn.ffn_block_cuda.launches,
         "moe_similarity": similarity.sim_cuda.launches}
  print(f"serve {what}: {time.perf_counter() - tic:.3f} s, launches {got}",
        flush=True)
  if got != want:
    raise RuntimeError(f"serve {what}: expected launches {want}, got {got}")
  return out


def serve_cli_phase(torch, ffn, similarity, cfg_path, exp):
  """Phase 12 (a): ``mmt_tpu_torch.serve.main`` on phase 11's
  trained_model.pth and config: --build_index over the config's eval set
  with 4 --query captions (exact), then the same queries --quantize
  int8 from the saved index.  Launches exactly 4 B1 per video batch of
  the build, 12 B1 and 1 B4 per exact query batch, 12 B1 and 0 B4 per
  int8 one; the hits well-formed.  Returns the two runs' launches."""
  from mmt_tpu_torch import serve, serving

  cfg = json.loads(pathlib.Path(cfg_path).read_text())
  video_batches = -(-CLI_VAL_VIDEOS
                    // cfg["final_eval_sets"][0]["args"]["batch_size"])
  index_path = pathlib.Path(exp) / "serve_index.npz"
  base = ["--config", str(cfg_path), "--checkpoint",
          str(pathlib.Path(exp) / "trained_model.pth"), "--topk", "5",
          "--device", "cuda"]
  for q in SERVE_CLI_QUERIES:
    base += ["--query", q]
  runs = {}
  def quiet_main(argv):
    """serve.main(argv), its stdout (one JSON line a query) checked
    against what it returned and not shown."""
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
      results = serve.main(argv)
    printed = [json.loads(line) for line in buf.getvalue().splitlines()]
    if printed != results:
      raise RuntimeError(f"serve cli printed {printed}, returned {results}")
    return results

  for what, argv, want in (
      ("cli --build_index + exact query",
       ["--build_index", str(index_path)],
       {"ffn_block": VIDEO_LAYERS * video_batches + TEXT_LAYERS,
        "moe_similarity": 1}),
      ("cli --index --quantize int8 query",
       ["--index", str(index_path), "--quantize", "int8"],
       {"ffn_block": TEXT_LAYERS, "moe_similarity": 0})):
    runs[what] = (serve_counted(torch, ffn, similarity,
                                lambda: quiet_main(base + argv), want, what),
                  want)
  index = serving.RetrievalIndex.load(index_path)
  if len(index) != CLI_VAL_VIDEOS:
    raise RuntimeError(f"serve cli: index of {len(index)} videos")
  ids = set(index.video_ids)
  for what, (results, _) in runs.items():
    if [r["query"] for r in results] != list(SERVE_CLI_QUERIES):
      raise RuntimeError(f"serve {what}: answered {results}")
    check_hits([r["hits"] for r in results], 5, ids, what)
  exact, q8 = (res for res, _ in runs.values())
  same = [[h["video_id"] for h in a["hits"]] == [h["video_id"]
                                                  for h in b["hits"]]
          for a, b in zip(exact, q8)]
  print(f"serve cli: {len(index)} videos indexed ({video_batches} video "
        f"batches); top-5 ids of int8 equal to exact's for {sum(same)} of "
        f"{len(same)} queries; first hits {json.dumps(exact[0]['hits'][:2])}",
        flush=True)
  return {what: want for what, (_, want) in runs.items()}


def serve_tokenizer(root):
  """A WordPiece tokenizer over SERVE_WORDS (written to ``root``)."""
  from mmt_tpu_torch.tokenization import WordPieceTokenizer

  vocab = ["[PAD]", "[UNK]", "[CLS]", "[SEP]", "[MASK]"] + sorted(
      set(SERVE_WORDS))
  path = pathlib.Path(root) / "vocab.txt"
  path.write_text("\n".join(vocab) + "\n")
  return WordPieceTokenizer(str(path))


def serve_queries(rng, n):
  return [" ".join(rng.choice(SERVE_WORDS, size=5)) for _ in range(n)]


def http_json(url, payload=None):
  """(reply, seconds) of one GET (or POST of ``payload``)."""
  import urllib.request

  tic = time.perf_counter()
  req = url if payload is None else urllib.request.Request(
      url, data=json.dumps(payload).encode(),
      headers={"Content-Type": "application/json"})
  with urllib.request.urlopen(req, timeout=120) as r:
    body = json.loads(r.read())
  return body, time.perf_counter() - tic


def pct_ms(xs, p):
  xs = sorted(xs)
  return round(1e3 * xs[min(len(xs) - 1, int(p / 100 * len(xs)))], 3)


def serve_traffic(serving, engine, rng, traffic, what, card):
  """``traffic`` (requests, queries a request, topk) against a fresh
  ``serve_http`` of ``engine``: GET for one query a request, POST else.
  Prints the server's /statz percentiles (only these requests) and the
  client's; checks every reply."""
  import urllib.parse

  n, batch, topk = traffic
  # No access-log line a request (the INFO logging phase 12 (a)'s CLI
  # configured): measured as scripts/bench_serving.py measured the JAX
  # engine's server.
  log = logging.getLogger(serving.__name__)
  level = log.level
  log.setLevel(logging.WARNING)
  server = serving.serve_http(engine, port=0, block=False)
  base = f"http://127.0.0.1:{server.server_address[1]}"
  lat = []
  ids = set(engine._staged_ids)
  try:
    for _ in range(n):
      queries = serve_queries(rng, batch)
      if batch == 1:
        body, dt = http_json(f"{base}/search?q="
                             f"{urllib.parse.quote(queries[0])}&topk={topk}")
      else:
        body, dt = http_json(f"{base}/search",
                             {"queries": queries, "topk": topk})
      check_hits(body["results"], topk, ids, what)
      lat.append(dt)
    statz = http_json(f"{base}/statz")[0]
  finally:
    server.shutdown()
    server.server_close()
    log.setLevel(level)
  if statz["requests"] != n or statz["errors"] or statz["queries"] != n * batch:
    raise RuntimeError(f"serve {what}: /statz {statz}")
  s = statz["search_latency_ms"]
  print(f"serve {what}: {n} requests of {batch} queries, topk {topk}: "
        f"server /statz p50 {s['p50']} p90 {s['p90']} p99 {s['p99']} ms "
        f"(max {s['max']}); client p50 {pct_ms(lat, 50)} p99 "
        f"{pct_ms(lat, 99)} ms; {batch * n / sum(lat):.1f} queries/s "
        f"card: {card}", flush=True)
  return {"server": {k: s[k] for k in ("p50", "p90", "p99")},
          "client": {"p50": pct_ms(lat, 50), "p99": pct_ms(lat, 99)}}


def serve_profile(torch, ffn, similarity, engine, queries, topk, what,
                  card):
  """One search of ``queries`` under torch.profiler: wall, device time,
  idle share, and the device time split into SERVE_SPLIT's parts and the
  rest.  The counters say how many B1 and B4 launches the search made:
  each kernel of B1 and B4 counts at its mean recorded time times those
  launches (device_split's rule for activities the profiler missed), the
  other activities as recorded.  A session that recorded none of a
  launched kernel's activities is run again."""
  from torch.profiler import ProfilerActivity, profile

  engine.search(queries, topk)
  torch.cuda.synchronize()
  for _ in range(PROFILE_TRIES):
    b1, b4 = ffn.ffn_block_cuda.launches, similarity.sim_cuda.launches
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
      tic = time.perf_counter()
      engine.search(queries, topk)
      torch.cuda.synchronize()
      wall_ms = (time.perf_counter() - tic) * 1e3
    launches = {"B1": ffn.ffn_block_cuda.launches - b1,
                "B4": similarity.sim_cuda.launches - b4}
    launches["B4 scratch fill"] = launches["B4"]
    dev = device_events(prof)
    part_of = {e.key: next((p for p, names in SERVE_SPLIT.items()
                            if any(k in e.key for k in names)), "rest")
               for e in dev}
    seen = {part_of[e.key] for e in dev}
    if all(n == 0 or p in seen for p, n in launches.items()):
      break
    print(f"  profiler session missed a launched kernel ({launches}, "
          f"recorded {sorted(seen)}): run again", flush=True)
  else:
    raise RuntimeError(f"serve profile {what}: no whole session in "
                       f"{PROFILE_TRIES} tries")
  split = dict.fromkeys(list(SERVE_SPLIT) + ["rest"], 0.0)
  missed = []
  for e in dev:
    part = part_of[e.key]
    ms = e.self_device_time_total / 1e3
    if part in launches:
      if e.count != launches[part]:
        missed.append(f"{short_kernel_name(e.key)} {e.count}/{launches[part]}")
      ms *= launches[part] / e.count
    split[part] += ms
  total = sum(split.values())
  shown = ", ".join(f"{p} {ms:.4f} ({ms / total:.2%})"
                    for p, ms in split.items())
  top = sorted(dev, key=lambda e: e.self_device_time_total, reverse=True)
  print(f"serve profile {what}: wall {wall_ms:.3f} ms, device "
        f"{total:.4f} ms, idle share {1 - total / wall_ms:.4f}; {shown}; "
        f"activities the profiler missed (recorded/launched): "
        f"{missed or 'none'} card: {card}", flush=True)
  for e in top[:4]:
    print(f"  top device op {e.self_device_time_total / 1e3:.4f} ms "
          f"x{e.count} {e.key[:100]}", flush=True)
  return {"wall_ms": wall_ms, "device_ms": total, "split": split}


def check_witness(torch, k_scores, k_idx, p_sims, topk):
  """The kernel path's top-k against the plain path's full scores
  ``p_sims``: the sorted scores within SERVE_TOL, and every id in one
  top-k and not the other with a plain score within SERVE_TOL of the
  plain path's k-th (phase 3's witness rule, applied to ids).  Returns
  the worst score difference."""
  p_scores, p_idx = torch.topk(p_sims, topk)
  diff = float((k_scores - p_scores).abs().max())
  if diff > SERVE_TOL:
    raise RuntimeError(f"serve: top-{topk} scores differ by {diff}")
  kth = p_scores[:, -1]
  for q in range(p_sims.shape[0]):
    moved = set(k_idx[q].tolist()) ^ set(p_idx[q].tolist())
    for v in moved:
      if abs(float(p_sims[q, v] - kth[q])) > SERVE_TOL:
        raise RuntimeError(f"serve: query {q}'s id {v} is in one top-"
                           f"{topk} only, plain score {float(p_sims[q, v])}"
                           f" against the plain {topk}th {float(kth[q])}")
  return diff


def serve_scale_phase(torch, ops, ffn, similarity, flagship, dev, card):
  """Phase 12 (b): the full-width flagship (bf16, random weights from a
  seed) serving a synthetic index of SERVE_VIDEOS videos of the
  flagship's geometry (L2-normalised rows, L1 weights), exact and int8:
  exact launch counts a query batch, the kernel path's top-10 against
  the plain versions' (witness rule), HTTP traffic (interactive and
  bulk) with the server's and the client's percentiles, the device
  split of one query batch, overlap@10 of int8 with exact, and the
  pinned int8 quality rule on its planted corpus (at 10,000 x 1,000 all
  of it but R@K equality)."""
  import tempfile

  import numpy as np

  from mmt_tpu_torch import serving

  root = pathlib.Path(tempfile.mkdtemp(prefix="mmt_serve_"))
  try:
    tok = serve_tokenizer(root)
    model = flagship.flagship_model(device=dev, seed=0)
    gen = torch.Generator(device=dev).manual_seed(12)
    tic = time.perf_counter()
    emb = torch.randn(SERVE_VIDEOS, SERVE_M, SERVE_D, generator=gen,
                      device=dev)
    emb /= emb.norm(dim=-1, keepdim=True)
    w = torch.rand(SERVE_VIDEOS, SERVE_M, generator=gen, device=dev)
    w /= w.sum(-1, keepdim=True)
    index = serving.RetrievalIndex(
        emb.cpu().numpy(), w.cpu().numpy(),
        [f"video{i:07d}" for i in range(SERVE_VIDEOS)], [""] * SERVE_VIDEOS)
    del emb, w
    print(f"serve: index of {SERVE_VIDEOS} x {SERVE_M} x {SERVE_D} made in "
          f"{time.perf_counter() - tic:.1f} s "
          f"({index.vid_embds.nbytes / 1e9:.2f} GB fp32)", flush=True)
    rng = np.random.RandomState(7)
    q64 = serve_queries(rng, 64)
    out, hits = {}, {}
    for quant in (None, "int8"):
      label = quant or "exact"
      torch.cuda.synchronize()
      tic = time.perf_counter()
      engine = serving.RetrievalEngine(model, tok, index, quantize=quant)
      torch.cuda.synchronize()
      print(f"serve {label}: staged in {time.perf_counter() - tic:.1f} s, "
            f"{sum(t.numel() * t.element_size() for t in engine._dev_index) / 1e9:.3f}"
            f" GB on the card", flush=True)
      b4 = 0 if quant else 1
      for batch, topk in ((1, 5), (64, 10)):
        res = serve_counted(
            torch, ffn, similarity, lambda: engine.search(q64[:batch], topk),
            {"ffn_block": TEXT_LAYERS, "moe_similarity": b4},
            f"{label} query batch of {batch}")
        check_hits(res, topk, set(index.video_ids), label)
      hits[label] = engine.search(q64, 10)
      if quant is None:
        with engine._lock, torch.inference_mode():
          scores = torch.tensor([[h["score"] for h in r] for r in hits[label]],
                                device=dev)
          idx = torch.tensor([[int(h["video_id"][5:]) for h in r]
                              for r in hits[label]], device=dev)
          with ops.plain_versions():
            plain = engine._similarities(q64)
          diff = check_witness(torch, scores, idx, plain, 10)
        print(f"serve exact: kernel path vs plain versions, 64 queries: "
              f"top-10 scores max_abs_diff={diff:.3e} (limit {SERVE_TOL}); "
              f"witness rule held", flush=True)
      out[label] = {
          "interactive": serve_traffic(serving, engine, rng,
                                       SERVE_INTERACTIVE,
                                       f"{label} interactive (GET)", card),
          "bulk": serve_traffic(serving, engine, rng, SERVE_BULK,
                                f"{label} bulk (POST)", card),
          "profile": {b: serve_profile(torch, ffn, similarity, engine,
                                       q64[:b], k, f"{label} batch {b}",
                                       card)
                      for b, k in ((1, 5), (64, 10))}}
      del engine
      torch.cuda.empty_cache()
    overlap = np.mean([len({h["video_id"] for h in a}
                           & {h["video_id"] for h in b}) / 10
                       for a, b in zip(hits["exact"], hits["int8"])])
    print(f"serve: int8 vs exact at {SERVE_VIDEOS} random rows, 64 queries: "
          f"overlap@10 {overlap:.4f}", flush=True)
    # The pinned rule on its own corpus; at 10,000 x 1,000 all of it but
    # R@K equality, which the JAX package does not meet there either
    # (scripts/int8_quality.py gives the same R@1 and R@10 moves).
    for size in (SERVE_QUALITY_PINNED, SERVE_QUALITY):
      tic = time.perf_counter()
      rep = int8_quality(torch, serving, *planted_corpus(*size), device=dev)
      faults = int8_quality_faults(rep)
      print(f"serve: int8 quality on the planted corpus {size} (videos, "
            f"queries) in {time.perf_counter() - tic:.1f} s: "
            f"{json.dumps(rep)}; faults {faults}", flush=True)
      if size != SERVE_QUALITY_PINNED:
        faults = [f for f in faults if f not in ("R1", "R5", "R10")]
      if faults:
        raise RuntimeError(f"serve: int8 quality rule broken at {size}: "
                           f"{faults}")
      out[f"int8_quality_{size[0]}"] = rep
    out["overlap@10"] = float(overlap)
    return out
  finally:
    shutil.rmtree(root, ignore_errors=True)


def serve_kernel_cases(torch, ffn, similarity, dev, card):
  """Phase 12 (c): B1 at the serving path's text rows (SERVE_FFN_ROWS x
  768, I 3,072, bf16; phase 1's bf16 rules, every row tile bitwise
  equal) and B4 at SERVE_SIM_CASES (K 3,584; 1e-5) against their plain
  versions, each in CUDA-event ms and device ms, B4 also beside the fp32
  ``torch.mm`` of its numerator and with the device time of its k-major
  scratch fill.  Returns the further shapes of the ``ffn_block`` and
  ``moe_similarity`` entries (their own generator: the draws of the
  earlier phases are kept)."""
  gen = torch.Generator(device=dev).manual_seed(1212)
  rand = lambda *s: torch.randn(*s, generator=gen, device=dev)
  h, i, cd = 768, 3072, torch.bfloat16
  ffn_shapes = []
  for r in SERVE_FFN_ROWS:
    args = (rand(r, h), (rand(i, h) * 0.02).to(cd), rand(i) * 0.02,
            (rand(h, i) * 0.02).to(cd), rand(h) * 0.02, 1.0 + 0.1 * rand(h),
            0.1 * rand(h))
    kw = dict(eps=1e-12, compute_dtype=cd)
    got = ffn.ffn_block_cuda(*args, **kw)
    err = (got - ffn.ffn_block_plain(*args, **kw)).abs()
    max_err, mean_err = float(err.max()), float(err.mean())
    if not bool(torch.isfinite(got).all()) or max_err > 3e-2 or mean_err > 2e-3:
      raise RuntimeError(f"ffn_block R={r}: error {max_err}/{mean_err} "
                         "exceeds 3e-2 (max) / 2e-3 (mean)")
    check_tiles_equal(torch, ffn, f"ffn_block R={r} H={h} (serving)",
                      ffn.ffn_block_cuda, args, kw)
    b_ms, b_by = bound(4 * r * h * i, H100_BF16, args + (got,))
    case = {"shape": f"{r} x {h}, I {i}", "max_abs_err": max_err,
            "ms": time_ms(torch, lambda: ffn.ffn_block_cuda(*args, **kw)),
            "device_ms": device_ms(
                torch, lambda: ffn.ffn_block_cuda(*args, **kw)),
            "plain_ms": time_ms(torch,
                                lambda: ffn.ffn_block_plain(*args, **kw)),
            "bound_ms": b_ms, "bound_by": b_by, "library_ms": None,
            "launches_per_query_batch": TEXT_LAYERS}
    print(f"ffn_block serving R={r} H={h} I={i} bf16: max_abs_err="
          f"{max_err:.3e} mean_abs_err={mean_err:.3e} kernel_ms="
          f"{case['ms']:.4f} device_ms={case['device_ms']:.4f} plain_ms="
          f"{case['plain_ms']:.4f} bound {b_ms:.6f} ms ({b_by}) card: "
          f"{card}", flush=True)
    ffn_shapes.append(case)
  sim_shapes = []
  for q, v in SERVE_SIM_CASES:
    t, vv, tw, vw = sim_inputs(torch, q, v, SERVE_M, SERVE_D, dev, gen)
    call = lambda: similarity.sim_cuda(t, vv, tw, vw)
    got = call()
    max_err = float((got - similarity.sim_plain(t, vv, tw, vw)).abs().max())
    if not bool(torch.isfinite(got).all()) or max_err > 1e-5:
      raise RuntimeError(f"moe_similarity Q={q} V={v}: error {max_err}")
    split = device_split(torch, call)
    dev_ms = sum(split.values())
    fill = sum(ms for k, ms in split.items() if "k_major_kernel" in k)
    b_ms, b_by = bound(2 * q * v * SERVE_M * (SERVE_D + 1), H100_FP32,
                       (t, vv, tw, vw, got))
    case = {"shape": f"{q} x {v}, K {SERVE_M * SERVE_D}",
            "max_abs_err": max_err, "ms": time_ms(torch, call),
            "device_ms": dev_ms, "scratch_fill_device_ms": fill,
            "plain_ms": time_ms(torch,
                                lambda: similarity.sim_plain(t, vv, tw, vw)),
            "bound_ms": b_ms, "bound_by": b_by,
            "library_ms": time_ms(torch, lambda: torch.mm(t, vv.T)),
            "launches_per_query_batch": 1}
    print(f"moe_similarity serving Q={q} V={v} K={SERVE_M * SERVE_D}: "
          f"max_abs_err={max_err:.3e} kernel_ms={case['ms']:.4f} device_ms="
          f"{case['device_ms']:.4f} (k-major scratch fill {fill:.4f}, "
          f"{fill / case['device_ms']:.2%}) plain_ms={case['plain_ms']:.4f} "
          f"library_ms={case['library_ms']:.4f} (fp32 torch.mm of the "
          f"numerator) bound {b_ms:.6f} ms ({b_by}) card: {card}", flush=True)
    sim_shapes.append(case)
    del t, vv, tw, vw, got
  torch.cuda.empty_cache()
  return ffn_shapes, sim_shapes


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
  for source in ("assembler.cc", "wordpiece.cc"):
    tic = time.perf_counter()
    host_lib = _build.build_host(source)
    print(f"build: {host_lib.name} (host, {os.environ.get('CXX') or 'g++'}) "
          f"in {time.perf_counter() - tic:.1f} s", flush=True)
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

  train_launches, staged_step_ms, *step_ref, step = train_step_phase(
      torch, flagship, ops, ffn, similarity, dev, card)
  clock.done("train-step")
  train_profile_phase(torch, ffn, dropout, step, train_alone, dev, gen, card)
  del step
  torch.cuda.empty_cache()
  clock.done("train-profile")
  tp_launches = tp_phase(torch, parallel, ranking, sims, step_ref, dev, card)
  del sims, step_ref
  clock.done("tp")

  loader_bench_phase(card)
  clock.done("loader-bench")

  def serve_cli(cfg_path, exp):
    clock.done("train-cli")
    return serve_cli_phase(torch, ffn, similarity, cfg_path, exp)

  cli_launches, serve_launches = train_cli_phase(
      torch, ops, ffn, similarity, staged_step_ms, k_s, card, then=serve_cli)
  print(f"train-cli launches (2 epochs): {json.dumps(cli_launches)}",
        flush=True)
  clock.done("serve-cli")
  served = serve_scale_phase(torch, ops, ffn, similarity, flagship, dev,
                             card)
  clock.done("serve")
  ffn_shapes, sim_shapes = serve_kernel_cases(torch, ffn, similarity, dev,
                                              card)
  clock.done("serve-kernels")
  print(f"serve summary: {json.dumps(served)}", flush=True)
  entries["ffn_block"]["launches"] = launches["ffn_block"]
  entries["moe_similarity"]["launches"] = launches["moe_similarity"]
  for name in ("ffn_train_fwd", "ffn_train_bwd"):
    entries[name]["launches"] = train_launches[name]
  for name, n in tp_launches.items():
    entries[name]["launches"] = n
  # Phase 12: the serving path's own launches and shapes.
  for name, shapes in (("ffn_block", ffn_shapes),
                       ("moe_similarity", sim_shapes)):
    entries[name]["serving_launches"] = {
        what: want[name] for what, want in serve_launches.items()}
    entries[name]["serving_shapes"] = shapes
    entries[name]["max_abs_err"] = max(
        [entries[name]["max_abs_err"]] + [c["max_abs_err"] for c in shapes])
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
