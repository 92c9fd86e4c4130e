"""Run one cell of the benchmark once, on the CUDA card of this machine.

    python3 -m portbench.run --workload <name> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout. The cell (BENCHMARK.json's `workloads`) names
a configuration and a traffic mix, which set-up turns into batches of
proofs; the verifier (halo2_verifier_tpu_torch's BatchVerifier) streams a
few of them to warm up. The window then drives BatchVerifier.verify_stream
as a closed loop with a backlog: the generator hands the stream the
prepared batches, round and round, as fast as its pipeline takes them,
for `--seconds`. After the window the stream gets the traffic's probe
batch and drains; every answer it gave, warm-up and probe included, is
then held to the plain reference (judge.py).

The last line of standard output is the result: the cell's end-to-end
metrics, or with --trace 1 its per-layer metrics, `device` and
`breakdown`; its last key, `checks`, holds each number compared with its
limit, which are also the last lines of standard error. On the card,
torch.profiler records the window in both modes: an end-to-end metric
(device_us_per_proof) reads the device's busy time from it. Without a card, or with fewer than the cell asks for, the run
prints no result and exits 2.
"""

from __future__ import annotations

import time

_T_IMPORT = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import random  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
import traceback  # noqa: E402

from . import cell as cellmod  # noqa: E402
from . import judge as judgemod  # noqa: E402
from .peaks import peaks  # noqa: E402
from .record import BatchRecord, Run  # noqa: E402

BANNED = {"jax", "jaxlib", "flax", "halo2_verifier_tpu"}
COUNTERS = ("point_adds_dispatched", "msm_entries_dispatched",
            "decomp_points_dispatched", "plan_repins")
CACHE_VARS = ("TRITON_CACHE_DIR", "TORCH_EXTENSIONS_DIR", "CUDA_CACHE_PATH")


def process_start() -> float:
    """The process's start on the perf_counter clock (from /proc; where
    that cannot be read, this module's import)."""
    try:
        with open("/proc/self/stat") as f:
            fields = f.read().rsplit(")", 1)[1].split()
        with open("/proc/uptime") as f:
            uptime = float(f.read().split()[0])
        age = uptime - int(fields[19]) / os.sysconf("SC_CLK_TCK")
        return time.perf_counter() - age
    except (OSError, ValueError, IndexError):
        return _T_IMPORT


def window_rates(batches, t_start, t_end, parts=5):
    """proofs/s of the verdicts in each of `parts` equal slices of the
    window: how steady the rate was inside one run."""
    span = (t_end - t_start) / parts
    out = []
    for i in range(parts):
        a, b = t_start + i * span, t_start + (i + 1) * span
        n = sum(r.size for r in batches
                if r.verdict is not None and a <= r.verdict < b)
        out.append(n / span)
    return out


def banned_modules() -> list:
    return sorted({m.split(".")[0] for m in sys.modules} & BANNED)


def load_reader(root, name):
    path = root / "portbench" / "metrics" / f"{name}.py"
    if not path.is_file():
        raise cellmod.SpecError(f"no reader portbench/metrics/{name}.py")
    spec = importlib.util.spec_from_file_location(f"portbench_metric_{name}",
                                                  path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def card_info(torch, device) -> dict:
    info = {"kind": torch.cuda.get_device_name(device),
            "power_limit": "unknown"}
    try:
        q = subprocess.run(["nvidia-smi", "--query-gpu=power.limit",
                            "--format=csv,noheader", "-i",
                            str(torch.device(device).index or 0)],
                           capture_output=True, text=True, timeout=30)
        if q.returncode == 0 and q.stdout.strip():
            info["power_limit"] = q.stdout.strip().splitlines()[0]
    except (OSError, subprocess.TimeoutExpired):
        pass
    return info


def run_cell(spec, wl, seed, seconds, trace, device, root=cellmod.ROOT,
             t_proc=None, split=None, verifier_overrides=None, out=print):
    """One run of cell `wl` (a BENCHMARK.json workload entry); returns the
    result dict, `checks` last. device: "cuda" on the card; the tests pass
    "cpu" with the program's host MSM to drive the rest of a run here."""
    tick = [time.perf_counter()]
    import torch

    from halo2_verifier_tpu_torch import weights
    from halo2_verifier_tpu_torch.parallel.orchestrator import BatchVerifier

    split = {} if split is None else split
    t_proc = _T_IMPORT if t_proc is None else t_proc

    def phase(name):
        now = time.perf_counter()
        split[name] = now - tick[0]
        tick[0] = now

    phase("import_port")
    cfg = cellmod.load_config(spec, wl["config"], root)
    traffic = cellmod.load_traffic(wl["traffic"], root)
    params = weights.params_from_srs(str(cfg.srs))
    vk = weights.vk_from_reference(cfg.vk_bytes)
    phase("load_inputs")
    stream = cellmod.build_stream(cfg, traffic, seed)
    phase("build_batches")
    wrng = random.Random(f"weights:{seed}")
    r_minus_1 = cellmod.R - 1
    kwargs = dict(traffic.get("verifier", {}), **(verifier_overrides or {}))
    bv = BatchVerifier(params, vk, multiopen=cfg.multiopen,
                       hash_name=cfg.transcript, device=device,
                       rng=lambda: 1 + wrng.randrange(r_minus_1), **kwargs)
    stream_kw = traffic.get("stream", {})
    if trace:
        from .record import IntervalTimings

        bv.timings = IntervalTimings()
    phase("make_verifier")
    on_card = torch.device(device).type == "cuda"

    records, batches = [], []

    def take(batch, probe=False):
        records.append(BatchRecord(batch.size, tuple(sorted(batch.tampered)),
                                   probe, time.perf_counter()))
        batches.append(batch)
        return batch.proofs

    def drain(results, first):
        for i, res in enumerate(results, first):
            r = records[i]
            r.verdict = time.perf_counter()
            r.ok, r.failed, r.num_proofs = (res.ok, list(res.failed_indices),
                                            res.num_proofs)

    drain(bv.verify_stream((take(b) for b in stream.warm), **stream_kw), 0)
    n_warm = len(records)
    if on_card:
        torch.cuda.synchronize(device)
    phase("warm_batches")
    tracer = None
    if trace or on_card:
        from .trace import Tracer

        tracer = Tracer()
        tracer.start()
        phase("profiler_start")

    counters = {}
    state = {"t_end": None}

    def feed():
        i = 0
        while time.perf_counter() < state["t_end"]:
            yield take(stream.cycle[i % len(stream.cycle)])
            i += 1
        counters.update({k: getattr(bv, k, None) for k in COUNTERS})
        for b in stream.probe:
            yield take(b, probe=True)

    c0 = {k: getattr(bv, k, None) for k in COUNTERS}
    error = None
    t_start = time.perf_counter()
    state["t_end"] = t_start + seconds
    if tracer is not None:
        tracer.mark()
    try:
        drain(bv.verify_stream(feed(), **stream_kw), n_warm)
    except Exception:  # the answers that never came are counted missing
        error = traceback.format_exc()
    window_stop = time.perf_counter()
    if on_card:
        torch.cuda.synchronize(device)
        mem_peak = torch.cuda.max_memory_allocated(device)
    else:
        mem_peak = 0
    device_events = tracer.stop() if tracer is not None else None
    counters = {k: (counters.get(k, getattr(bv, k, None)) - c0[k]
                    if c0[k] is not None else None) for k in COUNTERS}
    program = {"stages": bv.timings.report()}
    stages = getattr(bv.timings, "intervals", None)
    del bv
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()

    valid, facts, ref_s = judgemod.timed_verdicts(cfg, stream, batches,
                                                  f"reference:{seed}")
    checks = judgemod.judge(records, batches, valid)
    card = card_info(torch, device) if on_card else {"kind": "cpu",
                                                     "power_limit": None}
    setup_s = t_start - t_proc
    run = Run(wl["name"], wl["config"], wl["traffic"], seconds, setup_s,
              t_start, state["t_end"], records[n_warm:], counters, facts,
              card, stages, device_events)
    kind = "per_layer" if trace else "end_to_end"
    metrics = {}
    for m in cellmod.metric_entries(spec, wl["name"], kind):
        v = load_reader(root, m["name"])(run)
        if v is not None:
            metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    window = run.verdicts_in_window()
    out(json.dumps({
        "info": "run", "workload": wl["name"], "seed": seed,
        "setup_split_s": split, "setup_s": setup_s,
        "window_s": seconds, "stream_s": window_stop - t_start,
        "batches_in_window": len(window),
        "proofs_in_window": sum(b.size for b in window),
        "tampered_in_window": sum(1 for b in window if b.tampered),
        "rate_by_fifth": window_rates(records[n_warm:], t_start,
                                      state["t_end"]),
        "counters": counters, "program": program, "facts": facts,
        "reference_s": ref_s, "card": card, "peaks": peaks(),
        "error": error}))
    failed = sum(c["value"] for c in checks.values())
    result = {"correct": judgemod.correct(checks) and error is None,
              "attempted": len(records), "failed": failed,
              "metrics": metrics,
              "device": {"platform": "gpu" if on_card else "cpu",
                         "kind": card["kind"], "count": wl["chips"],
                         "memory_peak_bytes": mem_peak,
                         "power_limit": card["power_limit"]}}
    if trace and device_events is not None:
        from .trace import breakdown, busy_intervals

        busy = busy_intervals(device_events, t_start, state["t_end"])
        result["device"]["busy_s"] = sum(b - a for a, b in busy)
        result["device"]["window_s"] = seconds
        result["breakdown"] = breakdown(device_events, stages, t_start,
                                        state["t_end"])
    result["checks"] = checks
    if error is not None:
        print(error, file=sys.stderr)
    return result


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python3 -m portbench.run")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    t_proc = process_start()
    t = time.perf_counter()
    split = {"python_start": _T_IMPORT - t_proc,
             "harness_imports": t - _T_IMPORT}
    import torch

    split["import_torch"] = time.perf_counter() - t
    spec = cellmod.load_spec()
    wl = cellmod.workload(spec, args.workload)
    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < wl["chips"]:
        print(f"portbench: {args.workload} needs {wl['chips']} CUDA "
              f"card(s); this machine has "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}"
              ". No result.", file=sys.stderr)
        return 2
    for var in CACHE_VARS:
        os.environ[var] = str(cellmod.ROOT / "portbench" / "_cache"
                              / var.lower())
    t = time.perf_counter()
    torch.cuda.init()
    torch.empty(1, device="cuda")
    torch.cuda.synchronize()
    split["cuda_context"] = time.perf_counter() - t
    result = run_cell(spec, wl, args.seed, args.seconds, args.trace, "cuda",
                      t_proc=t_proc, split=split)
    found = banned_modules()
    if found:
        print(f"portbench: modules loaded that the run must not load: "
              f"{found}. No result.", file=sys.stderr)
        return 3
    print(json.dumps(result), flush=True)
    for name, c in result["checks"].items():
        print(f"check {name} {c['value']} limit {c['limit']}",
              file=sys.stderr)
    sys.stderr.flush()
    return 0


if __name__ == "__main__":
    sys.exit(main())
