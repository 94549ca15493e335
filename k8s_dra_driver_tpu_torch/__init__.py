"""k8s-dra-driver-tpu, ported to PyTorch and CUDA for NVIDIA H100 GPUs.

The compute plane that a prepared DRA claim binds to, on a GPU: a claim's
CDI spec names the visible devices (``CUDA_VISIBLE_DEVICES``), a
continuous-batching ``ServingEngine`` binds to them, and each engine step
runs one batched decode attention through a CUDA C++ kernel written for
Hopper (``csrc/decode_attention.cu``).

Layout (the JAX package's, where a module has a counterpart there):

- ``compute``  decode attention (kernel wrapper + plain version), the kernel
               build, and the serving engine
- ``cdi``      per-claim CDI spec files with GPU device nodes and env
- ``pkg``      the metrics and durable-publish helpers the above need
- ``csrc``     CUDA C++ sources, built with ``nvcc`` at first use into
               ``build/`` (never at import)

This package imports ``torch`` and nothing of JAX or of the JAX package.
"""
