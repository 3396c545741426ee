"""The benchmark of the PyTorch and CUDA port, `quant_tpu_torch`.

`run.py` runs one cell of BENCHMARK.json on a card and prints its result
line; `control.py` reads the numbers the comparison's limits were set
from. See PERF.md at the repo's root for the cells, the metrics and the
limits.
"""
