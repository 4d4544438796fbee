#!/usr/bin/env python3
"""Compare the eval FFN kernels (B1 ffn_block, B6 ffn_partial) of two
checkouts of this repository on one NVIDIA GPU.

  python3 scripts/compare_ffn_kernels.py OLD_TREE NEW_TREE

Each tree is the root of a checkout (it holds ``mmt_tpu_torch/``); for an
older commit unpack it first, e.g. ``git archive <commit> mmt_tpu_torch |
tar -x -C build/parent``.  The trees run one after the other in processes
of their own, in the order old, new, new, old, each on the same bf16
inputs made from a seed: B1 at the video (10,900 x 512), text (1,500 x
768) and ragged (1,013 x 768) shapes with I = 3,072, B6 at the video and
text shapes with I/mp = 1,536.  Each process builds its tree's kernels,
times them (and the plain version) with CUDA events and their device
time under torch.profiler ("device": without the host's gaps), and saves
what they return.  The two trees need not agree bitwise (a new kernel may sum in
another order): each output of one tree must lie within the bf16 rule of
chip_smoke.py's kernel phase of the other's (max abs 3e-2, mean 2e-3; a
partial divided by its largest magnitude first), and each tree must
repeat itself bitwise.  Prints the times side by side with the card's
name and power limit; exits 1 if a rule fails or no CUDA device is there.
"""

from __future__ import annotations

import importlib.util
import json
import os
import subprocess
import sys
import tempfile

CASES = (("ffn_block", 10900, 512, 3072), ("ffn_block", 1500, 768, 3072),
         ("ffn_block", 1013, 768, 3072), ("ffn_partial", 10900, 512, 1536),
         ("ffn_partial", 1500, 768, 1536))
MAX_ERR, MEAN_ERR = 3e-2, 2e-3


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
  from mmt_tpu_torch.ops import ffn

  clock = timing()
  dev = torch.device("cuda", 0)
  gen = torch.Generator(device=dev).manual_seed(0)
  rand = lambda *s: torch.randn(*s, generator=gen, device=dev)
  bf16 = torch.bfloat16
  times, outputs = {}, {}
  for name, r, h, i in CASES:
    x = rand(r, h)
    w1, w2 = (rand(i, h) * 0.02).to(bf16), (rand(h, i) * 0.02).to(bf16)
    b1, b2 = rand(i) * 0.02, rand(h) * 0.02
    gamma, beta = 1.0 + 0.1 * rand(h), 0.1 * rand(h)
    if name == "ffn_block":
      args, kw = (x, w1, b1, w2, b2, gamma, beta), dict(eps=1e-12,
                                                        compute_dtype=bf16)
    else:
      args, kw = (x, w1, b1, w2), dict(compute_dtype=bf16)
    kernel, plain = (getattr(ffn, f"{name}_cuda"),
                     getattr(ffn, f"{name}_plain"))
    case = f"{name} {r} x {h}, I {i}"
    outputs[case] = kernel(*args, **kw).cpu()
    times[case] = clock.time_ms(torch, lambda: kernel(*args, **kw))
    times[f"{case} device"] = clock.device_ms(torch,
                                              lambda: kernel(*args, **kw))
    times[f"{case} plain"] = clock.time_ms(torch, lambda: plain(*args, **kw))
  torch.save({"times": times, "outputs": outputs}, out_path)


def agreement(a, b, partial):
  """(max, mean) abs difference, a partial's relative to its largest
  magnitude."""
  d = (a - b).abs()
  if partial:
    d = d / b.abs().max()
  return float(d.max()), float(d.mean())


def main(argv):
  if len(argv) == 3 and argv[1] == "--child":
    child(argv[2])
    return 0
  if len(argv) != 3:
    print(__doc__, file=sys.stderr)
    return 2
  import torch
  if not torch.cuda.is_available():
    print("compare_ffn_kernels: no CUDA device", file=sys.stderr)
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
  for case, old in first["old"]["outputs"].items():
    new = first["new"]["outputs"][case]
    repeat = all(torch.equal(first[w]["outputs"][case], run["outputs"][case])
                 for w, run in runs)
    max_err, mean_err = agreement(new, old,
                                  case.startswith("ffn_partial"))
    good = repeat and max_err <= MAX_ERR and mean_err <= MEAN_ERR
    print(f"{case}: new vs old max_abs_diff={max_err:.3e} "
          f"mean_abs_diff={mean_err:.3e} (rule {MAX_ERR:.0e} / "
          f"{MEAN_ERR:.0e}); each tree repeats itself bitwise {repeat}")
    ok = ok and good
  print(f"card: {card}")
  for name in runs[0][1]["times"]:
    print(name + " ms: " + ", ".join(
        f"{which} {run['times'][name]:.4f}" for which, run in runs))
  print(json.dumps({"card": card, "runs": [
      {"tree": which, **run["times"]} for which, run in runs]}))
  return 0 if ok else 1


if __name__ == "__main__":
  sys.exit(main(sys.argv))
