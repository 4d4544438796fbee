"""Host milliseconds a train step spends inside the program's
``mmt.step.optimizer`` span: its share of the ``mmt.step`` spans' host
seconds in the profiler slice, times the untraced window's mean host
milliseconds a ``train_step`` call (``host_ms_per_step.train``)."""

from perfbench import spans

UNIT = "ms"


def read(r):
  return spans.host_share_ms(r, "mmt.step.optimizer")
