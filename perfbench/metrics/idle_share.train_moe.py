"""Share of the untraced window of the moonlight train cells in which no
operation ran on the device: 1 - the device's busy seconds a step (the
union of the profiled slice's device activity over its steps) times the
window's steps, over the window's seconds (``idle_share.train``'s
reading, for this kind)."""

UNIT = "%"


def read(r):
  if r.kind != "train_moe":
    return None
  busy = r.slice.busy_s()
  if busy <= 0:
    return None
  w = r.window
  return 100.0 * (1.0 - busy / r.slice_units * w["units"] / w["seconds"])
