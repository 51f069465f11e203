"""The benchmark of ``mxnet_tpu_torch``, the PyTorch and CUDA port, on one
NVIDIA H100.  ``python3 -m portbench.run --workload <cell> --seed <n>
--seconds <s> --trace <0|1>`` runs one cell of ``BENCHMARK.json``.

Nothing here imports JAX or the JAX package, and ``reference/`` imports
nothing of the program under test.
"""
