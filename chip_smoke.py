#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (mmt_tpu_torch) once on one NVIDIA GPU.

  python3 chip_smoke.py          # from the repository root, one card

Phases, each of which raises (exit code 1, no final line) on failure:

1. Build both CUDA kernels from mmt_tpu_torch/csrc/ with nvcc (sm_90a).
2. Kernel phase: each kernel against its plain PyTorch version on the
   card, at the flagship eval shapes (FFN block: video 10,900 x 512 and
   text 1,500 x 768 rows with I = 3072, bf16 and fp32, plus a ragged row
   count; similarity: 1000 x 1000 with M = 7, D = 512, plus a ragged
   37 x 53 case with all-zero weight rows), with the max abs error and
   both times.  Tolerances: FFN fp32 atol 1e-4; FFN bf16 atol 3e-2 and
   mean abs error <= 2e-3; similarity atol 1e-5.
3. Reference phase: a tiny fp32 CENet on the card (kernels) against the
   same weights on the CPU (plain versions), sims atol 1e-4.
4. Slice phase: the full-width flagship CENet (bf16, random weights from
   a seed) embeds 1000 captions and 1000 videos in 20 chunks of 50, builds
   the 1k x 1k similarity and ranks it.  The launch counters must read
   exactly 16 x 20 = 320 FFN launches and at least one similarity launch;
   every output must be finite; the same eval with the plain versions
   must give sims within 2e-2.  Then the eval's wall time on both paths,
   median of 5 runs after a warm-up, taken in turns.

The last two lines of stdout are one JSON object of kernel results and
{"ok": true, "device": {...}}.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time

N_VIDEOS, CHUNK = 1000, 50
FFN_LAYERS = 12 + 4     # text + video tower layers, one FFN block each


def card_line():
  out = subprocess.run(
      ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
      capture_output=True, text=True, timeout=60, check=True)
  return out.stdout.strip().splitlines()[0]


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


def ffn_phase(torch, ffn, dev, gen):
  """Each FFN case: kernel vs plain version; returns the bf16 cases'
  worst error and the video-shape bf16 times."""
  cases = [(10900, 512, 3072, torch.bfloat16), (1500, 768, 3072,
                                                torch.bfloat16),
           (1013, 768, 3072, torch.bfloat16),
           (10900, 512, 3072, torch.float32), (1500, 768, 3072,
                                               torch.float32),
           (1013, 768, 3072, torch.float32)]
  worst_bf16, video_ms = 0.0, None
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
    print(f"ffn_block R={r} H={h} I={i} {name}: max_abs_err={max_err:.3e} "
          f"mean_abs_err={mean_err:.3e} kernel_ms={ms:.4f} "
          f"plain_ms={plain_ms:.4f}", flush=True)
    if not bool(torch.isfinite(got).all()):
      raise RuntimeError("ffn_block kernel produced non-finite values")
    if cd == torch.float32 and max_err > 1e-4:
      raise RuntimeError(f"ffn_block fp32 error {max_err} > 1e-4")
    if cd == torch.bfloat16:
      if max_err > 3e-2 or mean_err > 2e-3:
        raise RuntimeError(f"ffn_block bf16 error {max_err}/{mean_err} "
                           "exceeds 3e-2 (max) / 2e-3 (mean)")
      worst_bf16 = max(worst_bf16, max_err)
      if (r, h) == (10900, 512):
        video_ms = (ms, plain_ms)
  return worst_bf16, video_ms


def sim_phase(torch, similarity, dev, gen):
  """Similarity kernel vs plain version; returns the worst error and the
  1000 x 1000 times."""
  worst, times = 0.0, None
  for q, v, m, d, zero_rows in ((1000, 1000, 7, 512, False),
                                (37, 53, 7, 512, True)):
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
    t = (te * tw[:, :, None]).reshape(q, m * d)
    vv = (ve * vw[:, :, None]).reshape(v, m * d)
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
    worst = max(worst, max_err)
    if q == 1000:
      times = (ms, plain_ms)
  return worst, times


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
  card = card_line()
  print(f"card: {card}", flush=True)
  print(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"device {torch.cuda.get_device_name(0)}", flush=True)

  from mmt_tpu_torch import _build, evaluate, flagship, ops
  from mmt_tpu_torch.ops import ffn, similarity

  tic = time.perf_counter()
  lib_path = _build.build()
  _build.load_library()
  print(f"build: {lib_path.name} in {time.perf_counter() - tic:.1f} s",
        flush=True)
  for line in (lib_path.parent / "build.log").read_text().splitlines():
    if "registers" in line or "spill" in line:
      print(f"  ptxas: {line.strip()}")

  dev = torch.device("cuda", 0)
  gen = torch.Generator(device=dev).manual_seed(0)
  ffn_err, ffn_times = ffn_phase(torch, ffn, dev, gen)
  sim_err, sim_times = sim_phase(torch, similarity, dev, gen)
  reference_phase(torch, flagship, evaluate, dev)

  # ---- slice phase: the full-width flagship, 1k x 1k ----
  arch = flagship.flagship_arch()
  model = flagship.flagship_model(device=dev, compute_dtype=torch.bfloat16,
                                  seed=0)
  tic = time.perf_counter()
  batches = [flagship.batch_to_torch(
      flagship.make_batch(arch["expert_dims"], CHUNK, seed=1 + c), dev)
             for c in range(N_VIDEOS // CHUNK)]
  torch.cuda.synchronize()
  print(f"slice: flagship CENet bf16, {N_VIDEOS} videos in "
        f"{len(batches)} chunks of {CHUNK} (inputs made in "
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

  print(f"card: {card}")
  print(json.dumps({"kernels": [
      {"name": "ffn_block", "route": "cuda",
       "source": "mmt_tpu_torch/csrc/ffn_block.cu",
       "replaces": "mmt_tpu/ops/ffn.py:119",
       "launches": launches["ffn_block"], "max_abs_err": ffn_err,
       "ms": ffn_times[0], "plain_ms": ffn_times[1]},
      {"name": "moe_similarity", "route": "cuda",
       "source": "mmt_tpu_torch/csrc/moe_similarity.cu",
       "replaces": "mmt_tpu/ops/similarity.py:244",
       "launches": launches["moe_similarity"], "max_abs_err": sim_err,
       "ms": sim_times[0], "plain_ms": sim_times[1]},
  ]}))
  print(json.dumps({"ok": True, "device": {
      "platform": "gpu", "kind": torch.cuda.get_device_name(0),
      "count": torch.cuda.device_count()}}))
  return 0


if __name__ == "__main__":
  sys.exit(main())
