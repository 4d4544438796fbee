"""Which package strays in an ill-conditioned whole-run parity case.

For each text-tower initializer_range and config seed: the 2-epoch
parity run of tests/test_torch_trainer.py through the JAX CLI and the
port's CLI in float32 from the same initial weights
(``jax_and_port_runs``), then the port's CLI again from those weights
and on the same batches in float64 (every parameter, activation and
optimizer state).  With ``--asset`` the one case is instead both CLIs
starting the text tower from one HF-style asset at range 0.02
(tests/test_torch_txt_bert_init.py:asset_runs), with the port also run
from the initial weights moved by one rounding (three draws).  Prints
one JSON line per case: the largest relative gap of the trained epochs'
mean losses and the largest absolute gap of the final sims of each
float32 run against the float64 run, and of the two float32 runs
against each other.  The float32 run farther from the float64 one is
the one that strays.  With ``--matrix NAME`` the one case is instead a
config of tests/test_torch_config_matrix.py (``coll``, ``wo2v_vlad``,
...) in its parity setup at Adam's eps ``--eps`` (default the config's
1e-8), with the port also run from the initial weights moved by one
rounding (three draws).

  JAX_PLATFORMS=cpu python scripts/torch_parity_f64.py \\
      [--ranges 0.02] [--seeds 4] [--threads 1] [--asset]
      [--matrix coll [--eps 1e-8]]
"""

import argparse
import contextlib
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
from mmt_tpu_torch.models import cenet  # noqa: E402
from test_torch_trainer import (CONFIG_INIT_RANGE, jax_and_port_runs,  # noqa: E402
                                moved_by_one_rounding, parity_gaps, port_run)
from test_torch_txt_bert_init import asset_runs, make_workspace  # noqa: E402


@contextlib.contextmanager
def float64_port():
  """The port in float64 on the CPU: parameters made in the default dtype
  (float64), every ``.float()`` of the port's plain paths a ``.double()``,
  and the model's compute dtype float64."""
  kwargs_from_arch_args = cenet.cenet_kwargs_from_arch_args
  to_float = torch.Tensor.float

  def kwargs64(*args, **kwargs):
    model_kwargs, init = kwargs_from_arch_args(*args, **kwargs)
    return dict(model_kwargs, compute_dtype=torch.float64), init

  torch.set_default_dtype(torch.float64)
  torch.Tensor.float = lambda self, *a, **k: self.double(*a, **k)
  cenet.cenet_kwargs_from_arch_args = kwargs64
  try:
    yield
  finally:
    torch.set_default_dtype(torch.float32)
    torch.Tensor.float = to_float
    cenet.cenet_kwargs_from_arch_args = kwargs_from_arch_args


def report(workspace, exps, init, init_range, **case):
  """The port in float64 from ``init`` beside the float32 runs in
  ``exps`` (``port``, ``jax`` and any ``moved*``): one JSON line."""
  with float64_port():
    trainer = port_run(workspace, exps, "port64", init, init_range,
                       case.get("seed", 0))
    dtype = str(next(trainer.model.parameters()).dtype)
  moved = [parity_gaps(p, exps / "port")
           for p in sorted(exps.glob("moved*")) if p.is_dir()]
  print(json.dumps({
      **case, "initializer_range": init_range,
      "threads": torch.get_num_threads(), "f64_param_dtype": dtype,
      "port_vs_f64": parity_gaps(exps / "port", exps / "port64"),
      "jax_vs_f64": parity_gaps(exps / "jax", exps / "port64"),
      "port_vs_jax": parity_gaps(exps / "port", exps / "jax"),
      **({"port_vs_moved": moved} if moved else {})}), flush=True)


def matrix_report(root, name, eps):
  """``--matrix``: the config matrix case ``name`` at Adam's ``eps``:
  the JAX CLI, the port, three moved ports and the port in float64."""
  import test_torch_config_matrix as matrix
  data_dir, env = matrix.make_workspace(root)
  os.environ.update(env)
  workspace = (root, data_dir)
  exps = root / f"{name}_eps{eps}"
  exps.mkdir()
  _, _, init = matrix.jax_and_port_runs(workspace, exps, name, eps)
  for draw in range(3):
    matrix.port_run(workspace, exps, f"moved{draw}",
                    moved_by_one_rounding(init, draw), name, eps)
  with float64_port():
    trainer = matrix.port_run(workspace, exps, "port64", init, name, eps)
    dtype = str(next(trainer.model.parameters()).dtype)
  print(json.dumps({
      "matrix": name, "adam_eps": eps, "threads": torch.get_num_threads(),
      "f64_param_dtype": dtype,
      "port_vs_f64": parity_gaps(exps / "port", exps / "port64"),
      "jax_vs_f64": parity_gaps(exps / "jax", exps / "port64"),
      "port_vs_jax": parity_gaps(exps / "port", exps / "jax"),
      "port_vs_moved": [parity_gaps(exps / f"moved{d}", exps / "port")
                        for d in range(3)]}), flush=True)


def main():
  parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
  parser.add_argument("--ranges", type=float, nargs="+", default=[0.02])
  parser.add_argument("--seeds", type=int, nargs="+", default=[4])
  parser.add_argument("--threads", type=int, default=1)
  parser.add_argument("--asset", action="store_true",
                      help="both CLIs from one HF-style asset at range 0.02")
  parser.add_argument("--matrix", default=None,
                      help="a config of tests/test_torch_config_matrix.py")
  parser.add_argument("--eps", type=float, default=1e-8,
                      help="Adam's eps of the --matrix case")
  args = parser.parse_args()
  torch.set_num_threads(args.threads)
  with tempfile.TemporaryDirectory() as tmp:
    root = pathlib.Path(tmp)
    if args.matrix:
      matrix_report(root, args.matrix, args.eps)
      return
    if args.asset:
      space = make_workspace(root)
      workspace = space[:2]
      exps = root / "asset"
      exps.mkdir()
      _, _, init = asset_runs(space, exps)
      for draw in range(3):
        port_run(workspace, exps, f"moved{draw}",
                 moved_by_one_rounding(init, draw), CONFIG_INIT_RANGE)
      report(workspace, exps, init, CONFIG_INIT_RANGE, asset=True)
      return
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
        report(workspace, exps, init, init_range, seed=seed)


if __name__ == "__main__":
  main()
