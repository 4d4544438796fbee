"""Device milliseconds a retrieval eval spends on its ranks and metrics:
the union of the device operations inside the device-side annotations
of the program's ``mmt.eval.ranks`` span and of the ``mmt.ranks`` spans
nested in it, over the slice's evals."""

from perfbench import spans

UNIT = "ms"


def read(r):
  if r.kind != "eval" or not spans.on_card(r.slice):
    return None
  s = spans.device_s(r.slice, spans.RANKS)
  return None if s is None else 1e3 * s / r.slice_units
