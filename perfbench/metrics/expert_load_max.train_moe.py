"""How unevenly the router loads the held experts: in each MoE layer, the
busiest held expert's rows over the held experts' mean in the profiled
slice (1.0: even), from the layers' device row counters (``expert_rows``);
the largest over the layers."""

from perfbench import moe_flops

UNIT = "ratio"


def read(r):
  rows = getattr(r.cell, "moe_slice_rows", None)
  if r.kind != "train_moe" or rows is None:
    return None
  share = moe_flops.held_share(r.cell.cfg, rows)
  return share if share == share else None
