"""Device milliseconds a train step spends in its backward, over the
slice's steps.  Autograd's device thread launches the backward's
kernels, and the profiler files a kernel under the spans of the thread
that launched it, so the device-side annotation of ``mmt.step.backward``
(opened on the main thread) holds none of them.  The backward is read
from the one stream's order instead: in each step, the union of the
device operations between the end of ``mmt.step.loss``'s annotation and
the start of the optimizer's (``Optimizer.step#...``, inside
``mmt.step.optimizer``)."""

from perfbench import spans

UNIT = "ms"


def read(r):
  if r.kind != "train" or not spans.on_card(r.slice):
    return None
  s = spans.between_s(r.slice, spans.LOSS, spans.OPTIMIZER)
  return None if s is None else 1e3 * s / r.slice_units
