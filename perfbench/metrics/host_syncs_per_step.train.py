"""Host syncs a train step makes: the copies between the device and
pageable host memory (``spans.SYNC_COPIES``), which the host waits for,
inside the program's ``mmt.step`` spans, over the slice's steps."""

from perfbench import spans

UNIT = "count"


def read(r):
  if r.kind != "train" or not spans.on_card(r.slice):
    return None
  n = spans.syncs(r.slice, spans.STEP)
  return None if n is None else n / r.slice_units
