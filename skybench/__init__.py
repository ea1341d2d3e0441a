"""skybench: the benchmark of `cloudscape_tpu_torch` on one CUDA card.

`run` runs one cell of `BENCHMARK.json` (`python3 -m skybench.run`);
`kinds/` drives each kind of cell (`serve`: serving ticks; `cycle`: whole
maps through `update_cycle`); `configs/`, `traffic/`, `limits/` and
`metrics/` hold a file each per configuration, traffic mix, cell and
per-layer metric, found by name; `reference/` is the plain reference
the outputs are checked against; `control` reads the numbers the check's
limits are set from; `tests/` holds its CPU tests and the card's.
"""
