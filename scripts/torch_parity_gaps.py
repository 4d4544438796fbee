"""Whole-run parity gaps of the port's training CLI, on the CPU.

For each text-tower initializer_range, config seed and torch thread
count: the 2-epoch parity run of tests/test_torch_trainer.py through the
JAX CLI and through the port's CLI from the same initial weights, and
the port again from those weights moved by one rounding (three draws).
Prints one JSON line per case: the largest relative gap of the trained
epochs' mean losses and the largest absolute gap of the final sims, port
against JAX and port against each moved port.

  JAX_PLATFORMS=cpu python scripts/torch_parity_gaps.py \\
      [--ranges 0.02 0.5] [--seeds 0 1 2] [--threads 1 8]
"""

import argparse
import json
import os
import pathlib
import sys
import tempfile

import torch

TESTS = pathlib.Path(__file__).resolve().parent.parent / "tests"
sys.path.insert(0, str(TESTS.parent))
sys.path.insert(0, str(TESTS))

from mmt_tpu_torch.data import synthetic  # noqa: E402
from test_torch_trainer import (jax_and_port_runs, moved_by_one_rounding,  # noqa: E402
                                parity_gaps, port_run)


def main():
  parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
  parser.add_argument("--ranges", type=float, nargs="+", default=[0.02, 0.5])
  parser.add_argument("--seeds", type=int, nargs="+", default=[0, 1, 2])
  parser.add_argument("--threads", type=int, nargs="+", default=[1, 8])
  args = parser.parse_args()
  with tempfile.TemporaryDirectory() as tmp:
    root = pathlib.Path(tmp)
    data_dir = synthetic.generate(root, num_videos=14, num_test=6,
                                  experts={"rgb": 2048, "s3d": 1024},
                                  captions_per_video=3)
    os.environ["MMT_TPU_BERT_VOCAB"] = str(root / "vocab.txt")
    workspace = (root, data_dir)
    for init_range in args.ranges:
      for seed in args.seeds:
        exps = root / f"r{init_range}_s{seed}"
        exps.mkdir()
        _, _, init = jax_and_port_runs(workspace, exps, init_range, seed)
        for threads in args.threads:
          torch.set_num_threads(threads)
          port = f"port{threads}"
          port_run(workspace, exps, port, init, init_range, seed)
          moved = []
          for draw in range(3):
            name = f"moved{threads}_{draw}"
            port_run(workspace, exps, name, moved_by_one_rounding(init, draw),
                     init_range, seed)
            moved.append(parity_gaps(exps / name, exps / port))
          print(json.dumps({
              "initializer_range": init_range, "seed": seed,
              "threads": threads,
              "port_vs_jax": parity_gaps(exps / port, exps / "jax"),
              "port_vs_moved": moved}), flush=True)


if __name__ == "__main__":
  main()
