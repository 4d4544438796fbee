"""Host milliseconds a train step's call takes, by the benchmark's own
clock around each ``train_step`` call of the untraced window (its
mean)."""

UNIT = "ms"


def read(r):
  if r.kind != "train":
    return None
  host = r.window["host_s"]
  return 1e3 * sum(host) / len(host)
