"""device_us_per_proof: the card's busy time per verified proof, in
microseconds: the union of the device's kernel and copy intervals (from
torch.profiler) between the first and the last batch verdict inside the
window, over the proofs of the verdicts after the first up to the last,
the proofs that stream_proofs_per_s counts. What one proof costs the
card, whatever paces the host: a card that several verifier hosts feed
serves at most 1e6 / this many proofs per second."""

from portbench.trace import busy_intervals


def read(run):
    if not run.device:
        return None
    got = run.verdicts_in_window()
    if len(got) < 2:
        return None
    proofs = sum(b.size for b in got[1:])
    busy = sum(b - a for a, b in busy_intervals(run.device, got[0].verdict,
                                                got[-1].verdict))
    return 1e6 * busy / proofs if busy > 0 else None
