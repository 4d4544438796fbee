"""Share of the FFN kernels' roofline: the least time of every FFN call
of the slice (operations and bytes from its shapes, flops.ffn_bound_s)
over the device time of the FFN kernels' category."""

from perfbench import trace

UNIT = "%"


def read(r):
  if r.kind != "eval":
    return None
  spent = r.slice.by_category()[trace.FFN]
  if spent <= 0:
    return None
  return 100.0 * r.ffn_bound_s * r.slice_units / spent
