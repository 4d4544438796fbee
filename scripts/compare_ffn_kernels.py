#!/usr/bin/env python3
"""Compare the FFN kernels (B1 ffn_block, B6 ffn_partial, B2
ffn_train_fwd, B3 ffn_train_bwd, B7 ffn_train_fwd_partial) of two
checkouts of this repository on one NVIDIA GPU.

  python3 scripts/compare_ffn_kernels.py OLD_TREE NEW_TREE

Each tree is the root of a checkout (it holds ``mmt_tpu_torch/``); for an
older commit unpack it first, e.g. ``git archive <commit> mmt_tpu_torch |
tar -x -C build/parent``.  The trees run one after the other in processes
of their own, in the order old, new, new, old, each on the same bf16
inputs made from a seed: B1 at the video (10,900 x 512), text (1,500 x
768) and ragged (1,013 x 768) shapes with I = 3,072, B6 at the video and
text shapes with I/mp = 1,536, B2 and B3 (add_dz on and off) at the b32
train step's video (6,976 x 512), text (960 x 768) and the ragged shape
with I = 3,072, B7 at those three shapes with I/mp = 1,536.  Each
process builds its tree's kernels,
times them (and the plain version) with CUDA events and their device
time under torch.profiler ("device": without the host's gaps), and saves
what they return.  The two trees need not agree bitwise (a new kernel may sum in
another order): each output of one tree must lie within the bf16 rule of
chip_smoke.py's kernel phase of the other's (max abs 3e-2, mean 2e-3; a
partial divided by its largest magnitude first; B2's and B3's outputs by
``check_outputs``, the rules of its train-kernel phase, B7's by
``check_partial``, those of its partial-kernel phase), and each tree
must repeat itself bitwise; whether the trees agree bitwise is printed.
Prints the times side by side with the card's
name and power limit; exits 1 if a rule fails or no CUDA device is there.
"""

from __future__ import annotations

import importlib.util
import json
import os
import subprocess
import sys
import tempfile

TRAIN_SHAPES = ((6976, 512), (960, 768), (1013, 768))
TRAIN_CASES = ("ffn_train_fwd", "ffn_train_bwd", "ffn_train_bwd add_dz=False")
CASES = ((("ffn_block", 10900, 512, 3072), ("ffn_block", 1500, 768, 3072),
          ("ffn_block", 1013, 768, 3072), ("ffn_partial", 10900, 512, 1536),
          ("ffn_partial", 1500, 768, 1536))
         + tuple((name, r, h, 3072) for name in TRAIN_CASES
                 for r, h in TRAIN_SHAPES)
         + tuple(("ffn_train_fwd_partial", r, h, 1536)
                 for r, h in TRAIN_SHAPES))
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
  from mmt_tpu_torch.ops import dropout, ffn

  clock = timing()
  dev = torch.device("cuda", 0)
  gen = torch.Generator(device=dev).manual_seed(0)
  rand = lambda *s: torch.randn(*s, generator=gen, device=dev)
  bf16 = torch.bfloat16
  times, outputs = {}, {}
  for case_name, r, h, i in CASES:
    name, *flag = case_name.split()
    if name in ("ffn_train_fwd", "ffn_train_bwd"):
      fargs, dy = clock.train_inputs(torch, dropout, r, h, bf16, dev, gen)
      kw = dict(eps=1e-12, compute_dtype=bf16)
      args = fargs
      if name == "ffn_train_bwd":
        _, inter, z = ffn.ffn_train_fwd_plain(*fargs, **kw)
        _, drop, w1, _, w2, _, gamma, _ = fargs
        args, kw = (dy, z, inter, drop, w1, w2, gamma), dict(
            kw, add_dz=not flag)
    else:
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
    case = f"{case_name} {r} x {h}, I {i}"
    outputs[case] = tuple(o.cpu() for o in clock.as_tuple(kernel(*args,
                                                                  **kw)))
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


def train_agreement(torch, clock, case, new, old):
  """B2's or B3's outputs of the two trees by chip_smoke.py's
  ``check_outputs``: True if every output lies within its rule."""
  kname = case.split()[0]
  names, cd_names = clock.TRAIN_OUTS[kname]
  try:
    clock.check_outputs(torch, f"{case}: new vs old", torch.bfloat16,
                        dict(zip(names, new)), dict(zip(names, old)),
                        cd_names)
  except RuntimeError as e:
    print(e)
    return False
  return True


def partial_agreement(torch, clock, case, new, old):
  """B7's outputs (out, inter) of the two trees by chip_smoke.py's
  ``check_partial``: True if both lie within its rules."""
  names = ("out", "inter")
  try:
    clock.check_partial(torch, f"{case}: new vs old", torch.bfloat16,
                        dict(zip(names, new)), dict(zip(names, old)),
                        ("inter",))
  except RuntimeError as e:
    print(e)
    return False
  return True


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
  clock = timing()
  first = {which: run for which, run in reversed(runs)}
  for case, old in first["old"]["outputs"].items():
    new = first["new"]["outputs"][case]
    repeat = all(all(map(torch.equal, first[w]["outputs"][case],
                         run["outputs"][case])) for w, run in runs)
    same = all(map(torch.equal, new, old))
    if case.startswith("ffn_train_fwd_partial"):
      good = partial_agreement(torch, clock, case, new, old)
      print(f"{case}: new vs old within the partial-kernel rules {good}; "
            f"bitwise equal {same}; each tree repeats itself bitwise {repeat}")
    elif case.startswith("ffn_train"):
      good = train_agreement(torch, clock, case, new, old)
      print(f"{case}: new vs old within the train-kernel rules {good}; "
            f"bitwise equal {same}; each tree repeats itself bitwise {repeat}")
    else:
      max_err, mean_err = agreement(new[0], old[0],
                                    case.startswith("ffn_partial"))
      good = max_err <= MAX_ERR and mean_err <= MEAN_ERR
      print(f"{case}: new vs old max_abs_diff={max_err:.3e} "
            f"mean_abs_diff={mean_err:.3e} (rule {MAX_ERR:.0e} / "
            f"{MEAN_ERR:.0e}); bitwise equal {same}; each tree repeats "
            f"itself bitwise {repeat}")
    ok = ok and good and repeat
  print(f"card: {card}")
  for name in runs[0][1]["times"]:
    print(name + " ms: " + ", ".join(
        f"{which} {run['times'][name]:.4f}" for which, run in runs))
  print(json.dumps({"card": card, "runs": [
      {"tree": which, **run["times"]} for which, run in runs]}))
  return 0 if ok else 1


if __name__ == "__main__":
  sys.exit(main(sys.argv))
