"""step_ms.backlog (ms), engine step: the window's seconds over the engine
steps taken in it."""
from perfbench.readers import step_ms as read  # noqa: F401
