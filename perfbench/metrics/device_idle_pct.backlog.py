"""device_idle_pct.backlog (%), device: the share of the traced sub-window in
which no kernel, copy or fill ran."""
from perfbench.readers import device_idle_pct as read  # noqa: F401
