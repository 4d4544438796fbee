"""Host syncs a retrieval eval makes: the copies between the device and
pageable host memory (``spans.SYNC_COPIES``), which the host waits for,
inside the program's ``mmt.eval`` spans, over the slice's evals."""

from perfbench import spans

UNIT = "count"


def read(r):
  if r.kind != "eval" or not spans.on_card(r.slice):
    return None
  n = spans.syncs(r.slice, spans.EVAL)
  return None if n is None else n / r.slice_units
