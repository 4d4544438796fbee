"""Device milliseconds a moonlight train step spends in the library's
matrix products (the "library matmul" category: cuBLAS / CUTLASS
kernels: MLA, the shared experts, the dense layer, the router, the video
tower's attention), over the slice's steps; the grouped expert kernels
(``moe_grouped_...``, which the category's pattern also takes) are left
out: ``moe_ms_per_step.train_moe`` reads them."""

from perfbench import trace

UNIT = "ms"
GROUPED = "moe_grouped_"


def read(r):
  if r.kind != "train_moe":
    return None
  s = sum(e - b for n, b, e in r.slice.ops
          if trace.category(n) == trace.MATMUL and GROUPED not in n)
  return 1e3 * s / r.slice_units if s > 0 else None
