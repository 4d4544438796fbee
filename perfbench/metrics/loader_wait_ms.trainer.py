"""Host milliseconds a step of the trainer waits for its batch: the host
seconds of the program's ``mmt.loader.wait`` spans (train/trainer.py: one
``next()`` of the device prefetch over ``ExpertDataLoader``) in the
profiled epoch, over its steps."""

from perfbench import spans

UNIT = "ms"


def read(r):
  if r.kind != "trainer":
    return None
  s = spans.host_s(r.slice, "mmt.loader.wait")
  return None if s is None else 1e3 * s / r.slice_units
