"""Device milliseconds a train step spends in its forward: the union of
the device operations inside the device-side annotations of the
program's ``mmt.step.forward`` span and of the spans nested in it (the
towers and their FFN blocks), over the slice's steps."""

from perfbench import spans

UNIT = "ms"


def read(r):
  if r.kind != "train" or not spans.on_card(r.slice):
    return None
  s = spans.device_s(r.slice, spans.FORWARD)
  return None if s is None else 1e3 * s / r.slice_units
