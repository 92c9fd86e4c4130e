"""replay_marshal_ms: the self time of the program's stage `host_replay`
in the window: its intervals less the part that stage `replay_vm` on the
same thread covers, i.e. the staging of the VM's inputs and the copies of
its outputs; per batch handed over in the window, in ms. With
replay_vm_ms it sums to host_replay_ms. None where the program records no
`replay_vm`."""

from portbench.spans import batches, recorded, self_seconds

STAGE, CHILD = "host_replay", "replay_vm"


def read(run):
    n = batches(run)
    if n is None or not recorded(run, CHILD):
        return None
    return self_seconds(run, STAGE, (CHILD,)) / n * 1e3
