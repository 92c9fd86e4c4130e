"""main_unstaged_ms: the window less the union of every program stage on
the stream's main thread (the thread that runs `host_replay`), per batch
handed over in the window, in ms: the main thread's time that no span
explains. None where no replay ran in the window."""

from portbench.spans import batches, main_thread, unstaged_seconds


def read(run):
    n = batches(run)
    tid = main_thread(run) if n is not None else None
    if tid is None:
        return None
    return unstaged_seconds(run, tid) / n * 1e3
