"""Model FLOP utilisation of the trainer's window: the configuration's
model operations of every step run in the untraced window
(``flops.train_step_flops``), over the window's seconds (epoch
boundaries and the loader's waits included), as a share of the card's
peak in the configuration's dtype (fp32: 67 TFLOP/s)."""

UNIT = "%"


def read(r):
  if r.kind != "trainer":
    return None
  w = r.window
  return 100.0 * r.unit_flops * w["units"] / w["seconds"] / r.peak_flops
