"""Launch a group of CPU ranks for the PyTorch port's mesh tests: each rank
is a subprocess running one worker script, the group forms over gloo on a
free loopback port, and every wait is bounded (the rendezvous by the
worker's init_distributed(timeout=...), the processes here), so a hung
group fails fast instead of running the suite's clock out."""

import os
import socket
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GROUP_VARS = ("H2V_COORDINATOR", "H2V_NUM_PROCESSES", "H2V_PROCESS_ID",
              "H2V_LOCAL_DEVICE_IDS", "MASTER_ADDR", "MASTER_PORT", "RANK",
              "WORLD_SIZE", "LOCAL_RANK")


def free_port() -> int:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def rank_env(rank: int, n: int, port: int, style: str = "h2v") -> dict:
    """The environment of rank `rank` of `n`: the package's H2V_* variables
    or torchrun's, one torch thread."""
    env = {k: v for k, v in os.environ.items() if k not in GROUP_VARS}
    env["PYTHONPATH"] = os.pathsep.join(
        [REPO] + ([env["PYTHONPATH"]] if env.get("PYTHONPATH") else []))
    env["OMP_NUM_THREADS"] = "1"
    if style == "h2v":
        env.update(H2V_COORDINATOR=f"127.0.0.1:{port}",
                   H2V_NUM_PROCESSES=str(n), H2V_PROCESS_ID=str(rank))
    else:
        env.update(MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port),
                   WORLD_SIZE=str(n), RANK=str(rank), LOCAL_RANK=str(rank))
    return env


def start_ranks(script: str, n: int, workdir, style: str = "h2v") -> list:
    """Start `script` as n ranks (cwd = the repository, argv[1] =
    workdir), each writing its output to rank<r>.log in workdir (a file,
    not a pipe, so a rank that writes much never blocks before its
    collectives); returns the processes, for wait_ranks."""
    path = os.path.join(str(workdir), "rank_worker.py")
    with open(path, "w") as f:
        f.write(script)
    port = free_port()
    procs = []
    for r in range(n):
        with open(_log(workdir, r), "w") as log:
            procs.append(subprocess.Popen(
                [sys.executable, path, str(workdir)],
                env=rank_env(r, n, port, style), cwd=REPO, stdout=log,
                stderr=subprocess.STDOUT))
    return procs


def _log(workdir, rank: int) -> str:
    return os.path.join(str(workdir), f"rank{rank}.log")


def wait_ranks(procs, workdir, timeout: float = 240.0) -> list:
    """Each rank's output. Fails with the output of every rank that exits
    non-zero or outlives `timeout` seconds (all are killed then)."""
    deadline = time.monotonic() + timeout
    late = set()
    try:
        for r, p in enumerate(procs):
            try:
                p.wait(timeout=max(deadline - time.monotonic(), 1.0))
            except subprocess.TimeoutExpired:
                late.add(r)
                p.kill()
                p.wait()
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    outs = []
    for r in range(len(procs)):
        with open(_log(workdir, r)) as f:
            outs.append(f.read() + (f"\n[killed after {timeout} s]"
                                    if r in late else ""))
    bad = [f"rank {r} exit {p.returncode}:\n{out[-4000:]}"
           for r, (p, out) in enumerate(zip(procs, outs)) if p.returncode]
    assert not bad, "\n".join(bad)
    return outs


def run_ranks(script: str, n: int, workdir, timeout: float = 240.0,
              style: str = "h2v") -> list:
    """start_ranks, then wait_ranks."""
    return wait_ranks(start_ranks(script, n, workdir, style), workdir,
                      timeout)
