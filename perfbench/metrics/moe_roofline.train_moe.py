"""Share of the grouped expert kernels' roofline: the least time of the
slice's grouped calls (``moe_flops.grouped_bound_s``: each call's
operations at the fp32 peak or its bytes at the memory rate, the rows
from the MoE layers' device row counters over the slice) over the device
time of the ``moe_grouped_`` kernels, %."""

from perfbench import moe_flops
from perfbench.reference import moe_text as ref

UNIT = "%"


def read(r):
  rows = getattr(r.cell, "moe_slice_rows", None)
  if r.kind != "train_moe" or rows is None:
    return None
  spent = sum(e - b for n, b, e in r.slice.ops if "moe_grouped_" in n)
  if spent <= 0:
    return None
  cfg, t, n = r.cell.cfg, r.cell.traffic, r.slice_units
  tokens = t["batch"] * t["captions_per_video"] * cfg["max_text_words"]
  per_step = [x / n for x in moe_flops.steps_rows(cfg, rows)]
  bound = n * moe_flops.grouped_bound_s(ref.geometry(cfg), tokens, per_step)
  return 100.0 * bound / spent
