"""replay_vm_hash_ms: the part of the native replay VM's call (stage
replay_vm) spent in its op class hash, the Fiat-Shamir transcript's
Blake2b or Keccak256 absorbs and squeezes (a proof point's absorb
included). The program splits each call's wall time by the shares that
the VM timed on a sample of the batch's proofs and records the part as
stage `replay_vm_hash` inside `replay_vm`. Seconds of that stage in the
window, over all threads, per batch handed over in the window, in ms.
None where the program records no such stage."""

from portbench.spans import stage_ms

STAGE = "replay_vm_hash"


def read(run):
    return stage_ms(run, STAGE)
