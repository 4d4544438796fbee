"""Device milliseconds of the library's matrix products (the "library
matmul" category: cuBLAS / CUTLASS kernels) per step, over the slice."""

from perfbench import trace

UNIT = "ms"


def read(r):
  if r.kind != "train":
    return None
  ms = 1e3 * r.slice.by_category()[trace.MATMUL]
  return ms / r.slice_units if ms > 0 else None
