"""Share of the FFN kernels' roofline in a moonlight train step: the video
tower's B2 and B3 (the caption tower has no FFN block), the least time of
the slice's FFN calls from their shapes (``mixes/train_moe.ffn_calls``)
over the device time of the FFN kernels' category, in %
(``ffn_roofline.train``'s reading, for this kind)."""

from perfbench import trace

UNIT = "%"


def read(r):
  if r.kind != "train_moe":
    return None
  spent = r.slice.by_category()[trace.FFN]
  if spent <= 0:
    return None
  return 100.0 * r.ffn_bound_s * r.slice_units / spent
