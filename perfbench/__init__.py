"""The benchmark of the PyTorch and CUDA port (``k8s_dra_driver_tpu_torch``).

One command (``python3 -m perfbench.run``) runs one cell of
``BENCHMARK.json``. Configurations, traffic mixes and metric readers are
files that the harness finds by the names the manifest gives them; see
``perfbench/README.md``. Nothing here imports JAX or the JAX package.
"""
