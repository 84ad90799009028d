"""Process start to the window's start: imports, the kernels (built only on
a checkout's first run), the weights drawn on the card, the cell's warm-up."""


def read(run):
    return run.setup_s
