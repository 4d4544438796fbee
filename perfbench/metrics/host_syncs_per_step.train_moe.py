"""Host syncs a moonlight train step makes (``host_syncs_per_step.train``'s
reading, for this kind): the copies between the device and pageable host
memory inside the program's ``mmt.step`` spans, over the slice's steps."""

from perfbench import spans

UNIT = "count"


def read(r):
  if r.kind != "train_moe" or not spans.on_card(r.slice):
    return None
  n = spans.syncs(r.slice, spans.STEP)
  return None if n is None else n / r.slice_units
