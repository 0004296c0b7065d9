"""The benchmark of ``horovod_tpu_torch`` (the PyTorch and CUDA port) on
NVIDIA H100 cards: ``python -m portbench.run --workload <name> --seed <n>
--seconds <s> --trace <0|1>``. ``BENCHMARK.json`` at the repository's root
lists the cells and metrics; each configuration, traffic mix, model family
and per-layer metric is a file of its own under this directory, found by
its name."""
