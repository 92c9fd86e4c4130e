"""replay_vm_ms: the native replay VM's call alone (inside host_replay);
seconds of the program's stage `replay_vm` inside the window, over all
threads, per batch handed over in the window, in ms. None where the
program records no such stage."""

from portbench.spans import stage_ms

STAGE = "replay_vm"


def read(run):
    return stage_ms(run, STAGE)
