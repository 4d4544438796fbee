"""Device milliseconds a step spends in the grouped expert kernels
(csrc/moe_grouped.cu, named ``moe_grouped_...``), over the slice's steps.
Read by kernel name: a replayed step records no annotation."""

UNIT = "ms"
KERNELS = "moe_grouped_"


def read(r):
  if r.kind != "train_moe":
    return None
  s = sum(e - b for n, b, e in r.slice.ops if KERNELS in n)
  return 1e3 * s / r.slice_units if s > 0 else None
