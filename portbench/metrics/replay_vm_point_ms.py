"""replay_vm_point_ms: the part of the native replay VM's call (stage
replay_vm) spent in its op class point, the decoding of the proof's
points and their curve check against the sqrt pre-pass's roots (their
absorb is hash). The program splits each call's wall time by the shares
that the VM timed on a sample of the batch's proofs and records the part
as stage `replay_vm_point` inside `replay_vm`. Seconds of that stage in
the window, over all threads, per batch handed over in the window, in
ms. None where the program records no such stage."""

from portbench.spans import stage_ms

STAGE = "replay_vm_point"


def read(run):
    return stage_ms(run, STAGE)
