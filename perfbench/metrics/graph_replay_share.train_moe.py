"""Share of a moonlight train slice's steps that the program replayed as
one CUDA graph (``graph_replay_share.train``'s reading, for this kind):
the ``mmt.step`` host spans that hold an ``mmt.step.graph`` span, in %.
None where the slice has no ``mmt.step.graph`` span at all."""

from perfbench import spans

UNIT = "%"
GRAPH = spans.STEP + ".graph"


def read(r):
  if r.kind != "train_moe":
    return None
  steps = [(s, e) for n, s, e in r.slice.host if n == spans.STEP]
  graphs = [s for n, s, _ in r.slice.host if n == GRAPH]
  if not steps or not graphs:
    return None
  held = sum(any(lo <= g <= hi for g in graphs) for lo, hi in steps)
  return 100.0 * held / len(steps)
