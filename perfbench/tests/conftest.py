"""Tests of the benchmark harness.  Most run on the CPU at test widths;
those marked ``card`` need a CUDA card and skip without one (each test
decides for itself):

  python -m pytest perfbench/tests -q            # here
  python -m pytest perfbench/tests -q -m card    # on the card
"""


def pytest_configure(config):
  config.addinivalue_line("markers",
                          "card: needs a CUDA card; skips without one")
