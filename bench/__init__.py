"""The benchmark of the PyTorch and CUDA port (``src/repro_torch``): one
training cell at a time, on the card, against a plain float32 reference.
``python3 bench/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>``;
``BENCHMARK.json`` at the root names the cells, and each configuration,
traffic mix, cell and metric is a file of its own here, found by name."""
