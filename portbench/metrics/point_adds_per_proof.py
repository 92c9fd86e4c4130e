"""point_adds_per_proof: the program's count of device point adds
(BatchVerifier.point_adds_dispatched, pads included) over the window, per
proof handed over in the window."""


def read(run):
    proofs = sum(b.size for b in run.handed_in_window())
    adds = run.counters.get("point_adds_dispatched")
    return adds / proofs if proofs and adds is not None else None
