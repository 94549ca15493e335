"""step_mfu.backlog (%), whole step: the least time of the traced sub-window's
decode work over the sub-window's wall time, the whole step's share of
the card's roofline."""
from perfbench.readers import step_mfu as read  # noqa: F401
