"""Claim annotations of the drain controller.

The JAX package's ``kubeletplugin/remediation.py`` holds the drain
controller; this package has only the two annotation names that mark a
claim inside the drain → reallocation window, which the claim watcher
reads so that a drained claim's tombstone stands exactly as it does there.
The controller itself waits for the remediation slice.
"""

#: set on a claim whose devices are being drained off a tainted device
ANN_DRAIN = "gpu.nvidia.com/drain"
#: set on a claim whose drain failed terminally
ANN_DRAIN_FAILED = "gpu.nvidia.com/drain-failed"
