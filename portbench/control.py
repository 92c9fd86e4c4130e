"""The control of the comparison that decides `correct`: the plain
reference put in the program's place with one guarantee broken. It
replays every proof (a malformed one is still rejected) but skips the
final pairing check, so it accepts every proof that replays: the
soundness the configurations state ("a batch is accepted only if every
proof in it verifies") is gone. Its answers, judged by the real
reference as a run's are, must come out not correct.

    python3 -m portbench.control --workload <name> --seed <n> [--seed <m> ...]

answers, for each seed, the batches one run hands over besides its
window's repeats: the warm-up, one pass of the cycle and the probe, at
the cell's own sizes. It prints one JSON line per seed with the compared
numbers and their limits. The benchmark's own runs do not run
it.
"""

from __future__ import annotations

import argparse
import json
import sys

from . import cell as cellmod
from . import judge as judgemod
from .record import BatchRecord


def control_answers(cfg, stream, batches) -> list:
    ref = judgemod.reference_for(cfg, "control")
    ref.replay_items({k: stream.items[k]
                      for k in {b.key(p) for b in batches
                                for p in range(b.size)}})
    out = []
    for b in batches:
        failed = [p for p in range(b.size) if ref.duals[b.key(p)] is None]
        out.append(BatchRecord(b.size, tuple(sorted(b.tampered)), False,
                               0.0, 0.0, not failed, failed, b.size))
    return out


def control_checks(spec, wl, seed, root=cellmod.ROOT) -> dict:
    cfg = cellmod.load_config(spec, wl["config"], root)
    traffic = cellmod.load_traffic(wl["traffic"], root)
    stream = cellmod.build_stream(cfg, traffic, seed)
    batches = stream.warm + stream.cycle + stream.probe
    records = control_answers(cfg, stream, batches)
    valid, _facts, _s = judgemod.timed_verdicts(cfg, stream, batches,
                                                f"reference:{seed}")
    return judgemod.judge(records, batches, valid)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python3 -m portbench.control")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, action="append", required=True)
    args = ap.parse_args(argv)
    spec = cellmod.load_spec()
    wl = cellmod.workload(spec, args.workload)
    for seed in args.seed:
        checks = control_checks(spec, wl, seed)
        print(json.dumps({"workload": wl["name"], "seed": seed,
                          "control": "reference without its pairing check",
                          "correct": judgemod.correct(checks),
                          "checks": checks}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
