"""setup_s (s): from the start of the process to the first due request of
the window: imports, the claim, the engine, kernel loading (and building,
in a checkout's first run) and the warm-up."""


def read(run):
    return run.setup_s
