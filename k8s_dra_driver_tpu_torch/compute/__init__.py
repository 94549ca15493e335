"""GPU compute plane: attention kernels, the serving engine, burn-in.

Submodules are imported by name (``compute.flashattention``,
``compute.serving``, ``compute.burnin``, ...); nothing here builds or loads
a kernel at import.
"""
