"""Device milliseconds a step spends inside the profiler's
``Optimizer.step`` annotation (the union of the device operations that
lie in it), over the slice's steps."""

UNIT = "ms"


def read(r):
  if r.kind != "train":
    return None
  inside = r.slice.inside("Optimizer.step")
  if not inside:
    return None
  return 1e3 * inside / r.slice_units
