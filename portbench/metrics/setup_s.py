"""Process start to the first timed call: imports, the kernel library
(built on a checkout's first run, loaded after), building the function,
the warm-up calls at the cell's shapes."""


def read(window):
    return window.setup_s
