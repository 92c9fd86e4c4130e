"""stream_proofs_per_s: every proof whose batch verdict arrives in the
window, counted from the first verdict inside it, over the time from that
first verdict to the last one inside it. The stream's rate on the host's
clock, which the host paces; a per-layer reading, with no bound."""


def read(run):
    got = run.verdicts_in_window()
    if len(got) < 2:
        return None
    proofs = sum(b.size for b in got[1:])
    return proofs / (got[-1].verdict - got[0].verdict)
