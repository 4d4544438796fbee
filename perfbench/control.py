"""The control of the check that decides ``correct``, and the faults it
has to catch, read on the card at a cell's own size.

The control is the plain reference computed in TF32 (the precision below
the configurations' fp32 with TF32 off) put in the program's place; a
fault is the reference fed a broken batch in the program's place:
``half_batch`` (half of each batch's rows left out, the loss's mean
taken over the rest; train cells) or ``token`` (one caption's first
word id altered).  Each seed's readings are held to the cell's limits:
the control and every fault have to come out not correct, and their
readings set the upper end of each limit.

  python3 -m perfbench.control --workload msrvtt-eval-1k --seeds 1,2,3
  python3 -m perfbench.control --workload msrvtt-train-b32 --seeds 1,2,3 \\
      --fault half_batch

Runs on the card only (TF32 exists only there), at the cell's own size.
Prints one JSON line per seed and exits 1 if any seed came out correct.
"""

from __future__ import annotations

import argparse
import json
import sys


def half_batch(batch):
  return {k: (half_batch(v) if isinstance(v, dict) else v[:len(v) // 2])
          for k, v in batch.items()}


def altered_token(batch):
  ids = batch["token_ids"].clone()
  ids[0, 0, 0, 0] += 1
  return dict(batch, token_ids=ids)


FAULTS = {"tf32": None, "half_batch": half_batch, "token": altered_token}


def control_numbers(cell, fault="tf32"):
  """{number: the reading of ``fault``} of ``cell``."""
  transform = FAULTS[fault]
  prog = cell.mix.reference(cell, tf32=transform is None,
                            transform=transform)
  ref = cell.mix.reference(cell)
  return cell.mix.numbers(prog, ref)


def main(argv=None):
  from perfbench import checks, run

  ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
  ap.add_argument("--workload", required=True)
  ap.add_argument("--seeds", required=True)
  ap.add_argument("--fault", choices=sorted(FAULTS), default="tf32")
  args = ap.parse_args(argv)
  run.pin_caches()
  import torch

  if not torch.cuda.is_available():
    print("the control needs a CUDA card", file=sys.stderr)
    return 2
  torch.backends.cuda.matmul.allow_tf32 = False
  torch.backends.cudnn.allow_tf32 = False
  failed_all = True
  for seed in map(int, args.seeds.split(",")):
    cell = run.Cell(args.workload, seed, "cuda:0")
    outside, table = checks.judge(control_numbers(cell, args.fault),
                                  cell.limits)
    failed_all &= bool(outside)
    print(json.dumps({"workload": cell.name, "seed": seed,
                      "fault": args.fault, "correct": not outside,
                      "checks": table}), flush=True)
  return 0 if failed_all else 1


if __name__ == "__main__":
  sys.exit(main())
