"""setup_s (s, host clock): from the start of the process to the window's
opening: imports, the CUDA context, loading (on a first run, building) the
kernel library, drawing the cell's inputs and the warm-up jobs."""


def read(run):
    return run.setup_s
