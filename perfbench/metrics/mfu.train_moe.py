"""Model FLOP utilisation of the moonlight train window: the model
operations of every step run in the untraced window
(``moe_flops.train_step_flops``; the routed experts' at the rows the MoE
layers' device counters took in the window), over the window's seconds,
as a share of the card's fp32 peak (67 TFLOP/s)."""

from perfbench import moe_flops
from perfbench.reference import moe_text as ref

UNIT = "%"


def read(r):
  if r.kind != "train_moe":
    return None
  w, t, cfg = r.window, r.cell.traffic, r.cell.cfg
  step = moe_flops.train_step_flops(cfg, t["batch"], t["captions_per_video"],
                                    routed_rows=0)
  routed = 3 * moe_flops.routed_row_flops(ref.geometry(cfg)) * w["held_rows"]
  return 100.0 * (w["units"] * step + routed) / w["seconds"] / r.peak_flops
