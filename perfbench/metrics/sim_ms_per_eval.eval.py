"""Device milliseconds of the similarity and rank kernels (B4, its
k-major copy, B5) per eval, over the slice."""

from perfbench import trace

UNIT = "ms"


def read(r):
  if r.kind != "eval":
    return None
  ms = 1e3 * r.slice.by_category()[trace.SIM]
  return ms / r.slice_units if ms > 0 else None
