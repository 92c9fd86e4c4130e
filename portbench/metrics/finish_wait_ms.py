"""finish_wait_ms: the main thread's block on the oldest batch's finish;
seconds of the program's stage `finish_wait` inside the window, over all
threads, per batch handed over in the window, in ms. None where the
program records no such stage."""

from portbench.spans import stage_ms

STAGE = "finish_wait"


def read(run):
    return stage_ms(run, STAGE)
