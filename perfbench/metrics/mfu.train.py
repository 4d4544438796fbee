"""Model FLOP utilisation of the train window: the configuration's
model operations of every step run in the untraced window, over the
window's seconds, as a share of the card's published peak in the
configuration's dtype (fp32: 67 TFLOP/s)."""

UNIT = "%"


def read(r):
  if r.kind != "train":
    return None
  w = r.window
  return 100.0 * r.unit_flops * w["units"] / w["seconds"] / r.peak_flops
