"""The benchmark of `repro_torch`, the PyTorch and CUDA port of HADES.

`python3 portbench/run.py --workload <cell> --seed <n> --seconds <s>
--trace <0|1>` runs one cell of `BENCHMARK.json` on the CUDA card and
prints one JSON line. Configurations (`configs/<name>.json` and `.py`),
traffic mixes (`traffic/<name>.json`) and per-layer metrics
(`metrics/<name>.py`) are found by the names `BENCHMARK.json` gives, so a
cell or a metric is added by adding files. The plain references that
decide `correct` are under `reference/`; they import nothing of the port.
"""
