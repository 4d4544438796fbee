"""Share of the untraced window of the eval cells in which no operation ran
on the device: 1 - the device's busy seconds a eval times the window's
evals, over the window's seconds.  The busy seconds a eval are the
union of the device's activity intervals over the profiled slice, divided
by the slice's evals; the seconds come from the untraced window, so the
profiler's own host overhead, which slows the slice, does not count as
idle."""

UNIT = "%"


def read(r):
  if r.kind != "eval":
    return None
  busy = r.slice.busy_s()
  if busy <= 0:
    return None
  w = r.window
  return 100.0 * (1.0 - busy / r.slice_units * w["units"] / w["seconds"])
