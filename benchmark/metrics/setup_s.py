"""Process start to the window's opening: imports, the card's start, the
pools written, the kernels built or loaded, the warm job."""


def read(run):
    return run.setup_s
