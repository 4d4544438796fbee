"""Run one cell of the benchmark of mmt_tpu_torch, once, on this
machine's card.

  python3 -m perfbench.run --workload msrvtt-train-b32 --seed 7 \\
      --seconds 30 --trace 0

A cell (``workloads/<name>.json``) names a configuration
(``configs/<config>.json``: the model's widths, switches, dtype, optimizer
and loss) and a traffic mix (``traffic/<traffic>.json``: its parameters,
and the program in ``mixes/<mix>.py`` that drives the system with them).
The run makes the weights and inputs on the card from ``--seed``, sets
up and warms up the program (``setup_s`` runs from the process's start
to here), measures for ``--seconds``, then checks what the timed path
produced against the plain reference in ``reference/`` (``checks.py``).

``--trace 0`` prints the cell's end-to-end metrics; ``--trace 1`` measures
the same window, then records a torch.profiler slice of the timed path
and prints the per-layer metrics, each read by its own file
``metrics/<metric>.py`` (one that finds nothing to read is left out).
The last line of standard output is one JSON object; the numbers checked
and their limits are the last lines of standard error.

The run keeps to two cores (``pin_cores``): on the card's host the
train cells are paced by the host's dispatch, and a process whose threads
move between cores read up to 30% apart from run to run.

Without a CUDA card, or with fewer cards than the cell asks for, the run
exits with code 2 and prints no result.  If jax, jaxlib, flax or the JAX
package mmt_tpu is loaded once the window has closed, it exits with code
3 and prints no result.
"""

from __future__ import annotations

import argparse
import gc
import importlib
import importlib.util
import json
import os
import pathlib
import sys
import time

HERE = pathlib.Path(__file__).resolve().parent
CHECKOUT = HERE.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "mmt_tpu")


def process_start_time():
  """Wall-clock time at which this process started (Linux /proc); the
  time of this module's import where /proc cannot say."""
  try:
    ticks = int(pathlib.Path("/proc/self/stat").read_text()
                .rsplit(")", 1)[1].split()[19])
    boot = next(float(line.split()[1]) for line in
                pathlib.Path("/proc/stat").read_text().splitlines()
                if line.startswith("btime"))
    return boot + ticks / os.sysconf("SC_CLK_TCK")
  except (OSError, ValueError, IndexError, StopIteration):
    return _IMPORTED


_IMPORTED = time.time()


def pin_caches():
  """Every build and kernel cache at a fixed directory of the checkout."""
  build = CHECKOUT / "build"
  os.environ["TORCH_EXTENSIONS_DIR"] = str(build / "torch_extensions")
  os.environ["TRITON_CACHE_DIR"] = str(build / "triton")


def pin_cores():
  """Keep the run's threads (the Python thread that dispatches, autograd's
  device thread, the CUDA runtime's) on two of the cores this process may
  use, so that where they run does not change from run to run; core 0,
  which takes most interrupts, is left out where there are more.
  Returns the cores kept."""
  cpus = sorted(os.sched_getaffinity(0))
  keep = cpus[1:3] if len(cpus) > 2 else cpus
  for tid in os.listdir("/proc/self/task"):  # threads started so far
    os.sched_setaffinity(int(tid), keep)
  return keep


def forbidden_modules():
  """The JAX-side packages loaded in this process, by whole top-level
  name."""
  return sorted({m.split(".")[0] for m in list(sys.modules)}
                & set(FORBIDDEN))


def read_json(root, kind, name):
  path = pathlib.Path(root) / kind / f"{name}.json"
  return json.loads(path.read_text())


class Cell:
  """A workload file with its configuration and traffic, for one seed on
  one device."""

  def __init__(self, name, seed, device, root=HERE):
    w = read_json(root, "workloads", name)
    self.name, self.seed, self.device = name, int(seed), device
    self.config_name, self.traffic_name = w["config"], w["traffic"]
    self.chips, self.why = int(w["chips"]), w["why"]
    self.end_to_end = w["end_to_end"]
    self.limits = w.get("limits", {})
    self.cfg = read_json(root, "configs", w["config"])
    self.traffic = read_json(root, "traffic", w["traffic"])
    self.mix = importlib.import_module(f"perfbench.mixes.{self.traffic['mix']}")


def metric_readers(root=HERE):
  """{metric name: its module}, one per file under metrics/."""
  readers = {}
  for path in sorted((pathlib.Path(root) / "metrics").glob("*.py")):
    spec = importlib.util.spec_from_file_location(
        f"perfbench_metric_{path.stem}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    readers[path.stem] = mod
  return readers


class Reading:
  """What a per-layer metric reads: the cell, its window (untraced), the
  profiler slice and its units, and the yardstick's counts per unit."""

  def __init__(self, cell, window, slice_, slice_units):
    from perfbench import flops

    self.cell, self.kind = cell, cell.mix.KIND
    self.window, self.slice, self.slice_units = window, slice_, slice_units
    self.unit_flops = cell.mix.unit_flops(cell)
    self.ffn_bound_s = flops.ffn_bound_total_s(cell.mix.ffn_calls(cell),
                                               cell.cfg["dtype"])
    self.peak_flops = flops.PEAK_FLOPS[cell.cfg["dtype"]]


def run_cell(cell, seconds, trace, started, root=HERE):
  """Set up, measure, read and check ``cell``: (the result object,
  the checks table)."""
  import torch

  from perfbench import checks, port
  from perfbench import trace as trace_lib

  dev = torch.device(cell.device)
  cuda = dev.type == "cuda"
  sync = (lambda: torch.cuda.synchronize(dev)) if cuda else (lambda: None)
  mix = cell.mix
  build_s = port.load_kernels(dev)
  state = mix.setup(cell)
  sync()
  setup_s = time.time() - started
  win = mix.window(state, seconds, sync)
  extra, device = {}, {}
  if trace:
    work, units = mix.slice_work(state)
    slice_ = trace_lib.record(work, port.launch_counters(), dev)
    reading = Reading(cell, win, slice_, units)
    metrics = {}
    for name, mod in metric_readers(root).items():
      value = mod.read(reading)
      if value is not None:
        metrics[name] = {"value": value, "unit": mod.UNIT}
    device = {"busy_s": slice_.busy_s(), "window_s": slice_.window_s}
    extra["breakdown"] = slice_.breakdown()
  else:
    metrics = {name: {"value": v, "unit": unit}
               for name, (v, unit) in mix.end_to_end(cell, win).items()
               if name in cell.end_to_end}
    metrics["setup_s"] = {"value": setup_s, "unit": "s"}
  peak = torch.cuda.max_memory_allocated(dev) if cuda else 0
  prog = mix.results(state)
  del state
  gc.collect()
  if cuda:
    torch.cuda.empty_cache()
  ref = mix.reference(cell)
  try:
    numbers = mix.numbers(prog, ref)
  except (ValueError, RuntimeError, KeyError, IndexError) as e:
    print(f"the check could not compare the outputs: {e!r}", file=sys.stderr)
    numbers = {"outputs_comparable": 1.0}
  outside, table = checks.judge(numbers, cell.limits)
  result = {
      "correct": not outside, "attempted": win["units"],
      "failed": len(outside),
      "metrics": metrics,
      "device": {"platform": "gpu" if cuda else dev.type,
                 "kind": torch.cuda.get_device_name(dev) if cuda else "cpu",
                 "count": cell.chips, "memory_peak_bytes": peak, **device},
      **extra,
      "build_s": build_s,
      "checks": table,
  }
  return result, table


def main(argv=None):
  started = process_start_time()
  ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
  ap.add_argument("--workload", required=True)
  ap.add_argument("--seed", type=int, required=True)
  ap.add_argument("--seconds", type=float, required=True)
  ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
  args = ap.parse_args(argv)
  pin_caches()
  import torch

  cell = Cell(args.workload, args.seed, "cuda:0")
  if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
    print(f"{cell.name} needs {cell.chips} CUDA card(s); this machine has "
          f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
          file=sys.stderr)
    return 2
  torch.set_num_threads(len(pin_cores()))
  torch.backends.cuda.matmul.allow_tf32 = False
  torch.backends.cudnn.allow_tf32 = False
  torch.cuda.set_device(0)
  result, table = run_cell(cell, args.seconds, args.trace, started)
  bad = forbidden_modules()
  if bad:
    print(f"loaded in the run's process: {bad}; the benchmark drives "
          "mmt_tpu_torch alone", file=sys.stderr)
    return 3
  print(json.dumps(result), flush=True)
  for name, t in table.items():
    print(f"check {name} {t['value']!r} limit {t['limit']!r}",
          file=sys.stderr)
  print(f"correct {result['correct']}", file=sys.stderr, flush=True)
  return 0


if __name__ == "__main__":
  sys.exit(main())
