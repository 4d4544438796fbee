#!/usr/bin/env python3
"""Compare the similarity kernels (B4 moe_similarity, B5 fused_ranks) of
two checkouts of this repository on one NVIDIA GPU.

  python3 scripts/compare_sim_kernels.py OLD_TREE NEW_TREE

Each tree is the root of a checkout (it holds ``mmt_tpu_torch/``); for an
older commit unpack it first, e.g. ``git archive <commit> | tar -x -C
build/parent``.  The trees run one after the other in processes of their
own, in the order old, new, new, old, each on the same inputs made from a
seed: the similarity at 1,000 x 1,000 and at 32 x 32, the fused counts
at 20,000 x 20,000 and at 50,000 x 50,000 (M = 7, D = 512, fp32).  Each
process builds its tree's kernels, times them with CUDA events and saves
what they return; then the two trees' outputs are compared bitwise (the
kernels promise one fmaf chain in K order per value, whatever the tile)
and the times are printed side by side with the card's name and power
limit.  Exits 1 if an output differs or no CUDA device is there.
"""

from __future__ import annotations

import importlib.util
import json
import os
import subprocess
import sys
import tempfile


ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def timing():
  """chip_smoke.py of this checkout, whose ``time_ms`` (CUDA events) and
  ``device_ms`` (torch.profiler) time every tree alike."""
  spec = importlib.util.spec_from_file_location(
      "chip_smoke", os.path.join(ROOT, "chip_smoke.py"))
  mod = importlib.util.module_from_spec(spec)
  spec.loader.exec_module(mod)
  return mod


def child(out_path):
  """Run in a tree (cwd and PYTHONPATH): time its kernels, save outputs."""
  import torch
  torch.backends.cuda.matmul.allow_tf32 = False
  from mmt_tpu_torch.ops import ranking, similarity

  time_ms = timing().time_ms
  dev = torch.device("cuda", 0)
  gen = torch.Generator(device=dev).manual_seed(0)

  def inputs(q, v, m=7, d=512):
    te = torch.randn(q, m, d, generator=gen, device=dev)
    ve = torch.randn(v, m, d, generator=gen, device=dev)
    te /= te.norm(dim=-1, keepdim=True)
    ve /= ve.norm(dim=-1, keepdim=True)
    tw = torch.rand(q, m, generator=gen, device=dev)
    vw = torch.rand(v, m, generator=gen, device=dev)
    tw, vw = tw / tw.sum(-1, keepdim=True), vw / vw.sum(-1, keepdim=True)
    return ((te * tw[:, :, None]).reshape(q, m * d),
            (ve * vw[:, :, None]).reshape(v, m * d), tw, vw)

  times, outputs = {}, {}
  for n, reps in ((1000, 50), (32, 50)):
    args = inputs(n, n)
    outputs[f"sims_{n}"] = similarity.sim_cuda(*args).cpu()
    times[f"moe_similarity {n} x {n}"] = time_ms(
        torch, lambda: similarity.sim_cuda(*args), reps)
  for n, reps in ((20_000, 5), (50_000, 3)):
    t, c, tw, cw = inputs(n, n)
    gtcol = torch.arange(n, device=dev)
    args = (t, c, tw, cw, ranking._gt_sims(t, c, tw, cw, gtcol), gtcol,
            torch.zeros(n, device=dev))
    closer, tied = ranking.fused_counts_cuda(*args)
    outputs[f"closer_{n}"], outputs[f"tied_{n}"] = closer.cpu(), tied.cpu()
    times[f"fused_ranks {n} x {n}"] = time_ms(
        torch, lambda: ranking.fused_counts_cuda(*args), reps)
    if n == 20_000:
      times["torch.mm 20000 x 20000 (numerator only)"] = time_ms(
          torch, lambda: torch.mm(t, c.T), reps)
    del t, c, tw, cw, args
    torch.cuda.empty_cache()
  torch.save({"times": times, "outputs": outputs}, out_path)


def main(argv):
  if len(argv) == 3 and argv[1] == "--child":
    child(argv[2])
    return 0
  if len(argv) != 3:
    print(__doc__, file=sys.stderr)
    return 2
  import torch
  if not torch.cuda.is_available():
    print("compare_sim_kernels: no CUDA device", file=sys.stderr)
    return 1
  trees = {"old": os.path.abspath(argv[1]), "new": os.path.abspath(argv[2])}
  card = subprocess.run(
      ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
      capture_output=True, text=True).stdout.strip()
  runs = []
  with tempfile.TemporaryDirectory() as tmp:
    for i, which in enumerate(("old", "new", "new", "old")):
      out = os.path.join(tmp, f"{i}.pt")
      env = dict(os.environ, PYTHONPATH=trees[which])
      subprocess.run([sys.executable, os.path.abspath(__file__), "--child",
                      out], cwd=trees[which], env=env, check=True)
      runs.append((which, torch.load(out)))
  ok = True
  first = {which: run for which, run in reversed(runs)}
  for name, old in first["old"]["outputs"].items():
    same = all(torch.equal(old, run["outputs"][name]) for _, run in runs)
    print(f"{name}: bitwise equal in all four runs {same}")
    ok = ok and same
  print(f"card: {card}")
  for name in runs[0][1]["times"]:
    print(name + " ms: " + ", ".join(
        f"{which} {run['times'][name]:.4f}" for which, run in runs))
  print(json.dumps({"card": card, "runs": [
      {"tree": which, **run["times"]} for which, run in runs]}))
  return 0 if ok else 1


if __name__ == "__main__":
  sys.exit(main(sys.argv))
