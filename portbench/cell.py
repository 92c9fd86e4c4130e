"""A cell of the benchmark, found by name: its configuration, its traffic
mix and the batches the traffic makes from the configuration's proofs.

Everything specific to a configuration, a traffic mix or a metric is data
under this folder (configs/<name>.json, traffic/<name>.json,
metrics/<name>.py); `BENCHMARK.json` at the checkout's root names them.

A configuration file names, relative to the checkout's root, its proof
pack (`proofs`: an npz of proof bytes and the key's sha256), its key and
public inputs (`key_and_inputs`: an npz of the serialized verifying key
and each proof's public inputs as 32-byte little-endian scalars) and its
SRS (`srs`), with its `multiopen` and `transcript`. It holds the sha256 of
the proofs' and the public inputs' bytes (`proofs_sha256`,
`inputs_sha256`), so a changed input file fails loading, as a key that
is not the pack's does.

A traffic file gives the batch sizes, how the seed orders them, which
batches hold a tampered proof, the batches that warm the verifier up,
and the verifier's and the stream's keyword arguments (the program's
defaults where absent). Proofs are tiled into a batch as the repository's
bench.py tiles them: position p holds the configuration's proof
p mod (number of proofs). A tampered proof is that proof with its first
public input plus one.
"""

from __future__ import annotations

import hashlib
import json
import random
from dataclasses import dataclass
from pathlib import Path

import numpy as np

from .reference.constants import R

ROOT = Path(__file__).resolve().parent.parent
TRAFFIC_KEYS = {"batch_sizes", "shuffle", "cycles", "tamper_every", "probe",
                "warm_batches", "verifier", "stream"}


class SpecError(ValueError):
    """A name or file of the benchmark that cannot be found or read."""


def load_spec(root: Path = ROOT) -> dict:
    with open(root / "BENCHMARK.json") as f:
        return json.load(f)


def workload(spec: dict, name: str) -> dict:
    for w in spec["workloads"]:
        if w["name"] == name:
            return w
    raise SpecError(f"no workload {name!r} in BENCHMARK.json")


def config_entry(spec: dict, name: str) -> dict:
    for c in spec["configs"]:
        if c["name"] == name:
            return c
    raise SpecError(f"no configuration {name!r} in BENCHMARK.json")


def metric_entries(spec: dict, workload_name: str, kind: str) -> list:
    """The `kind` ("end_to_end" or "per_layer") metrics the cell reports:
    those without a `workloads` key and those that list it."""
    return [m for m in spec[kind]
            if "workloads" not in m or workload_name in m["workloads"]]


@dataclass
class Config:
    name: str
    multiopen: str
    transcript: str
    srs: Path
    vk_bytes: bytes
    vk_sha256: str
    proofs: list          # bytes per distinct proof
    instances: list       # per proof: [[int, ...]] (one instance column)


def sha256_of(array) -> str:
    return hashlib.sha256(np.ascontiguousarray(array).tobytes()).hexdigest()


def load_config(spec: dict, name: str, root: Path = ROOT) -> Config:
    entry = config_entry(spec, name)
    path = root / entry["file"]
    if not path.is_file():
        raise SpecError(f"configuration file {entry['file']} is missing")
    with open(path) as f:
        raw = json.load(f)
    with np.load(root / raw["proofs"]) as pack:
        pack_proofs = pack["proofs"]
        proofs = [bytes(p.tobytes()) for p in pack_proofs]
        vk_sha256 = str(pack["vk_sha256"])
        seeds = pack["seeds"].copy()
    with np.load(root / raw["key_and_inputs"]) as fx:
        vk_bytes = fx["vk"].tobytes()
        inst = fx["instances"]
        if not np.array_equal(fx["seeds"], seeds):
            raise SpecError(f"{name}: the key's file and the proof pack "
                            "hold different proofs")
    digests = {"key": (hashlib.sha256(vk_bytes).hexdigest(), vk_sha256),
               "proofs": (sha256_of(pack_proofs), raw["proofs_sha256"]),
               "public inputs": (sha256_of(inst), raw["inputs_sha256"])}
    for what, (got, want) in digests.items():
        if got != want:
            raise SpecError(f"{name}: the sha256 of the {what} is {got}, "
                            f"not the recorded {want}")
    instances = [[[int.from_bytes(bytes(row), "little") for row in p]]
                 for p in inst]
    if len(instances) != len(proofs):
        raise SpecError(f"{name}: {len(proofs)} proofs and "
                        f"{len(instances)} sets of public inputs")
    return Config(name, raw["multiopen"], raw["transcript"],
                  root / raw["srs"], vk_bytes, vk_sha256, proofs, instances)


def load_traffic(name: str, root: Path = ROOT) -> dict:
    path = root / "portbench" / "traffic" / f"{name}.json"
    if not path.is_file():
        raise SpecError(f"no traffic file portbench/traffic/{name}.json")
    with open(path) as f:
        t = json.load(f)
    unknown = set(t) - TRAFFIC_KEYS
    if unknown:
        raise SpecError(f"traffic {name}: unknown keys {sorted(unknown)}")
    return t


def batch_sizes(traffic: dict) -> list:
    s = traffic["batch_sizes"]
    if isinstance(s, dict):
        return list(range(s["from"], s["to"] + 1, s["step"]))
    return list(s)


@dataclass
class Batch:
    """One batch object of the stream: its proofs as the verifier takes
    them and, for the judge, the keys of what each position holds (an int:
    the configuration's proof; ("tampered", i): proof i tampered)."""
    proofs: list
    tampered: dict        # position -> key of the tampered item
    n_items: int

    @property
    def size(self) -> int:
        return len(self.proofs)

    def key(self, pos: int):
        return self.tampered.get(pos, pos % self.n_items)


@dataclass
class Stream:
    cycle: list           # the window's batches, round and round
    warm: list            # what set-up streams first
    probe: list           # handed over after the window closes
    items: dict           # key -> (proof, instances) of every item used


def tampered_item(item):
    proof, inst = item
    return proof, [[(inst[0][0] + 1) % R] + list(inst[0][1:])] + inst[1:]


def build_stream(cfg: Config, traffic: dict, seed: int) -> Stream:
    """The batches of one run, all made here, so that the window's
    generator only hands them over. The same seed gives the same
    batches."""
    rng = random.Random(f"traffic:{seed}")
    base = list(zip(cfg.proofs, cfg.instances))
    n = len(base)
    items = {i: base[i] for i in range(n)}
    tiles = {}

    def tiled(size):
        # one list per batch object; the tuples are shared
        if size not in tiles:
            tiles[size] = [base[p % n] for p in range(size)]
        return list(tiles[size])

    def make(size, bad_positions=()):
        proofs = tiled(size)
        tampered = {}
        for pos in bad_positions:
            key = ("tampered", pos % n)
            items[key] = tampered_item(base[pos % n])
            proofs[pos] = items[key]
            tampered[pos] = key
        return Batch(proofs, tampered, n)

    sizes = batch_sizes(traffic)
    every = int(traffic.get("tamper_every", 0))
    order = []
    for _ in range(int(traffic.get("cycles", 1))):
        c = list(sizes)
        if traffic.get("shuffle"):
            rng.shuffle(c)
        order += c
    if every and len(order) % every:
        raise SpecError("a cycle's length must be a multiple of "
                        "tamper_every, so every Nth batch in stream order "
                        "holds a tampered proof")
    cycle = []
    for i, size in enumerate(order):
        bad = [rng.randrange(size)] if every and i % every == every - 1 \
            else []
        cycle.append(make(size, bad))
    largest = max(sizes)
    warm = cycle[:int(traffic.get("warm_batches", 2))]
    probe = []
    if traffic.get("probe"):
        half = largest // 2
        probe.append(make(largest, [rng.randrange(half),
                                    half + rng.randrange(largest - half)]))
    return Stream(cycle, warm, probe, items)


def expected(batch: Batch, valid: dict):
    """The reference's answer for a batch: (ok, failed positions)."""
    failed = [p for p in range(batch.size) if not valid[batch.key(p)]]
    return not failed, failed
