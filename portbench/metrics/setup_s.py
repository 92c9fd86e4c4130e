"""setup_s: from the process's start to the window's start: imports, the
CUDA context, loading the inputs, building the batches, the verifier and
its warm batches (kernel builds or loads, pins, recordings)."""


def read(run):
    return run.setup_s
