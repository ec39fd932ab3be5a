"""From the process's start to the window's first hand-off: imports, the
card's context, the program's build and load, the capture made and
staged, and the warm-up of the cell's shapes."""


def read(run):
    return run.setup_s
