"""Model FLOP utilisation of the eval window: the model operations of
every whole eval run in the untraced window, over the window's seconds,
as a share of the card's published peak in the configuration's dtype."""

UNIT = "%"


def read(r):
  if r.kind != "eval":
    return None
  w = r.window
  return 100.0 * r.unit_flops * w["units"] / w["seconds"] / r.peak_flops
