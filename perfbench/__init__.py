"""The benchmark of mmt_tpu_torch: one command runs one cell once
(``python3 -m perfbench.run``); BENCHMARK.json at the repository's root
lists the cells and metrics, and PERF.md says why each is there."""
