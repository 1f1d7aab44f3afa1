"""The benchmark of the PyTorch / CUDA port, `attentiondm_tpu_torch`.

`python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>`
from the root of a checkout runs one cell of `BENCHMARK.json` on the
CUDA device and prints its result as the last line of standard output."""
