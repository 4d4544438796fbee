"""Device milliseconds a step spends in the FFN blocks, whatever kernel
or plain version runs them: the union of the device operations inside
the device-side annotations of the program's ``mmt.ffn_op.fwd`` and
``mmt.ffn_op.bwd`` spans, over the slice's steps."""

from perfbench import spans

UNIT = "ms"


def read(r):
  if r.kind != "train" or not spans.on_card(r.slice):
    return None
  s = spans.device_s(r.slice, spans.FFN)
  return None if s is None else 1e3 * s / r.slice_units
