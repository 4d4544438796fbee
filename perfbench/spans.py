"""What the per-layer metrics read from the program's own spans
(``mmt_tpu_torch.utils.timing.span``) in a profiler slice: their host
seconds, the device seconds of the work launched in them, and the host
syncs inside them.

On the card a span is also a device-side annotation, but the profiler
links each kernel to the innermost span open on the thread that launched
it: an annotation covers, from its first to its last, only the kernels
its span launched outside any span nested in it.  A span that launches
nothing itself (``mmt.step.forward``, whose work lies in the towers) has
no annotation, and spans opened on the main thread hold none of the
kernels that autograd's device thread launches in the backward.  So a
layer's device time is read here from the annotations of the span and
of the spans nested in it (``device_s``), and the backward's from the
order of the one stream (``between_s``).

Every reader returns None where the slice holds no device operation
(off the card) or the spans it reads are missing (a program without
them).
"""

from __future__ import annotations

import bisect

STEP = "mmt.step"
EVAL = "mmt.eval"
# The FFN blocks' forward and backward, whatever kernel runs them.
FFN = ("mmt.ffn_op.fwd", "mmt.ffn_op.bwd")
# The forward's work: its span and the spans nested in it.
FORWARD = ("mmt.step.forward", "mmt.tower.text", "mmt.tower.video",
           "mmt.ffn_op.fwd")
LOSS = "mmt.step.loss"
# The optimizer's span and torch's own annotation inside it, which holds
# the optimizer's kernels: ``Optimizer.step#<class>.step``.
OPTIMIZER = ("mmt.step.optimizer", "Optimizer.step#")
RANKS = ("mmt.eval.ranks", "mmt.ranks")
# A copy between the device and pageable host memory is a host sync:
# PyTorch waits for the stream to finish it (``.cpu()``, ``.item()`` of a
# device tensor, a host tensor or list made into a device tensor).  The
# host ops' names cannot tell: most ``aten::item`` in a step read the
# host's own tensors (Adam's step counts).
SYNC_COPIES = ("Memcpy DtoH (Device -> Pageable)",
               "Memcpy HtoD (Pageable -> Device)")


def on_card(slice_):
  return bool(slice_.ops)


def host_s(slice_, name):
  """Host seconds of the host events named ``name``; None if none."""
  spans = [e - s for n, s, e in slice_.host if n == name]
  return sum(spans) if spans else None


def host_share_ms(r, name):
  """The host milliseconds a step of ``name``: its host seconds over those
  of ``mmt.step`` in the slice, times the untraced window's mean host
  milliseconds a ``train_step`` call.  The profiler's own overhead, which
  lengthens every span of the slice, cancels to first order."""
  if r.kind != "train" or not on_card(r.slice):
    return None
  part, whole = host_s(r.slice, name), host_s(r.slice, STEP)
  if part is None or not whole:
    return None
  host = r.window["host_s"]
  return 1e3 * part / whole * sum(host) / len(host)


def _merged(intervals):
  """Sorted, disjoint [lo, hi] covering ``intervals``."""
  merged = []
  for s, e in sorted(intervals):
    if merged and s <= merged[-1][1]:
      merged[-1][1] = max(merged[-1][1], e)
    else:
      merged.append([s, e])
  return merged


def _union_s(slice_, windows):
  """Seconds of the union of the device ops clipped to ``windows``, in
  one pass over the ops (an eval holds thousands of FFN windows and a
  hundred thousand ops)."""
  windows = _merged(windows)
  starts = [lo for lo, _ in windows]
  clipped = []
  for _, s, e in slice_.ops:
    k = max(bisect.bisect_right(starts, s) - 1, 0)
    while k < len(windows) and windows[k][0] < e:
      lo, hi = max(s, windows[k][0]), min(e, windows[k][1])
      if lo < hi:
        clipped.append((lo, hi))
      k += 1
  return sum(e - s for s, e in _merged(clipped))


def device_s(slice_, names):
  """Device seconds of the union of the ops inside the device-side
  annotations named in ``names`` (exactly); None if there is none."""
  windows = [(s, e) for n, s, e in slice_.annotations if n in names]
  return _union_s(slice_, windows) if windows else None


def between_s(slice_, after, before):
  """Device seconds, summed over the slice's steps, of the union of the
  ops between the end of each annotation named ``after`` and the start of
  the first annotation that follows it and whose name starts with one of
  ``before``.  One stream runs the step, so the order of the ops on the
  device is the order the host issued them.  None if no such pair."""
  ends = sorted(e for n, _, e in slice_.annotations if n == after)
  starts = sorted(s for n, s, _ in slice_.annotations
                  if n.startswith(before))
  windows = []
  for lo in ends:
    k = bisect.bisect_left(starts, lo)
    if k < len(starts):
      windows.append((lo, starts[k]))
  return _union_s(slice_, windows) if windows else None


def syncs(slice_, name):
  """Host syncs (``SYNC_COPIES``) inside the host spans named ``name``:
  the host waits in its span until the copy is done, so the copy lies
  inside the span on the profiler's clock.  None if there is no such
  span."""
  spans = _merged((s, e) for n, s, e in slice_.host if n == name)
  if not spans:
    return None
  starts = [lo for lo, _ in spans]
  count = 0
  for n, s, e in slice_.ops:
    if n in SYNC_COPIES:
      k = bisect.bisect_right(starts, s) - 1
      count += k >= 0 and e <= spans[k][1]
  return count
