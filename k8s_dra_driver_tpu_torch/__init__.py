"""k8s-dra-driver-tpu, ported to PyTorch and CUDA for NVIDIA H100 GPUs.

The compute plane that a prepared DRA claim binds to, on a GPU: a claim's
CDI spec names the visible devices (``CUDA_VISIBLE_DEVICES``), a
continuous-batching ``ServingEngine`` binds to them, and each engine step
runs one batched decode attention through a CUDA C++ kernel written for
Hopper (``csrc/decode_attention.cu``). The single-device compute plane
beside it: the burn-in block that a claimed device runs as its healthcheck
(``entry()``), the matmul bench, and exact flash attention through a second
kernel (``csrc/flash_attention.cu``).

Layout (the JAX package's, where a module has a counterpart there):

- ``compute``  flash and decode attention (kernel wrappers + plain
               versions), the kernel build, the serving engine, and the
               burn-in block and matmul bench
- ``entry``    the burn-in step with example arguments
- ``cdi``      per-claim CDI spec files with GPU device nodes and env
- ``pkg``      the metrics and durable-publish helpers the above need
- ``csrc``     CUDA C++ sources, built with ``nvcc`` at first use into
               ``build/`` (never at import)

This package imports ``torch`` and nothing of JAX or of the JAX package.
"""
