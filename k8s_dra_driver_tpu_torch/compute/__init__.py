"""GPU compute plane: decode attention and the serving engine.

Submodules are imported by name (``compute.flashattention``,
``compute.serving``); nothing here builds or loads a kernel at import.
"""
