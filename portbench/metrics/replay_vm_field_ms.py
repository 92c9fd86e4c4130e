"""replay_vm_field_ms: the part of the native replay VM's call (stage
replay_vm) spent in its op class field, the Fr arithmetic of the tape
(add, sub, mul, neg, the inversions, constants, public inputs) and the
export of the weighted outputs. The program splits each call's wall
time by the shares that the VM timed on a sample of the batch's proofs
and records the part as stage `replay_vm_field` inside `replay_vm`.
Seconds of that stage in the window, over all threads, per batch handed
over in the window, in ms. None where the program records no such
stage."""

from portbench.spans import stage_ms

STAGE = "replay_vm_field"


def read(run):
    return stage_ms(run, STAGE)
