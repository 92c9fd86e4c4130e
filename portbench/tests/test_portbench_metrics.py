"""The metric readers' arithmetic on synthetic runs."""

import math
import random

import pytest

from portbench import cell, run as runmod
from portbench.peaks import least_seconds
from portbench.record import BatchRecord, Run

FACTS = {"points_per_proof": 15, "left_terms_per_proof": 1,
         "left_terms_shared": 0, "right_terms_per_proof": 15,
         "right_terms_shared": 7}


def reader(name):
    return runmod.load_reader(cell.ROOT, name)


def synthetic(verdicts, sizes=None, tampered=(), stages=None, device=None,
              t_start=0.0, t_end=10.0, counters=None):
    sizes = sizes or [100] * len(verdicts)
    batches = [BatchRecord(s, (3,) if i in tampered else (), False,
                           v - 0.5, v, True, [], s)
               for i, (v, s) in enumerate(zip(verdicts, sizes))]
    return Run("w", "c", "t", t_end - t_start, 1.5, t_start, t_end, batches,
               counters or {}, FACTS, {}, stages, device)


def test_rate_is_first_to_last_verdict_inside_the_window():
    r = synthetic([0.5, 1.0, 2.0, 4.5, 10.5], sizes=[7, 100, 200, 300, 999])
    # verdicts at 0.5 .. 4.5 are inside; the first one's proofs start it
    assert reader("stream_proofs_per_s")(r) == pytest.approx(600 / 4.0)
    assert reader("setup_s")(r) == 1.5
    assert reader("stream_proofs_per_s")(synthetic([11.0])) is None


def test_p95_is_nearest_rank_over_every_batch_of_the_window():
    hand = list(range(40))
    r = synthetic([h + 0.1 for h in hand], t_end=100.0)
    for i, b in enumerate(r.batches):
        b.handed = b.verdict - (i + 1) / 1000   # latencies 1..40 ms
    assert reader("batch_latency_p95_ms")(r) == pytest.approx(38.0)
    r.batches[0].tampered = (5,)
    r.batches[1].tampered = (6,)
    assert reader("tampered_latency_p50_ms")(r) == pytest.approx(1.5)


def test_stage_metrics_clip_to_the_window_per_batch_handed_over():
    stages = [("host_replay", 1, -1.0, 1.0), ("host_replay", 2, 9.0, 12.0),
              ("host_pairing", 1, 2.0, 3.0)]
    r = synthetic([1.0, 2.0, 3.0, 4.0], stages=stages)
    # handed at 0.5 .. 3.5: 4 batches; replay inside: 1 + 1 s
    assert reader("host_replay_ms")(r) == pytest.approx(2000 / 4)
    assert reader("host_pairing_ms")(r) == pytest.approx(1000 / 4)
    assert reader("host_assemble_ms")(r) == 0.0
    assert reader("host_replay_ms")(synthetic([1.0])) is None


def test_device_idle_is_the_union_of_intervals():
    device = [("k", 1.0, 3.0), ("c", 2.0, 4.0), ("k", 9.0, 11.0),
              ("Memcpy HtoD", -1.0, 0.5)]
    r = synthetic([1.0, 2.0], device=device)
    assert reader("device_idle_pct")(r) == pytest.approx(100 * (1 - 4.5 / 10))


def test_device_time_per_proof_is_busy_between_first_and_last_verdict():
    # verdicts at 1, 2, 4 (sizes 100, 200, 300) are inside; 10.5 is not
    device = [("k", 0.5, 1.5), ("c", 1.2, 1.8), ("k", 3.0, 3.5),
              ("k", 3.9, 4.4), ("k", 5.0, 6.0)]
    r = synthetic([1.0, 2.0, 4.0, 10.5], sizes=[100, 200, 300, 400],
                  device=device)
    busy = 0.8 + 0.5 + 0.1
    assert reader("device_us_per_proof")(r) == pytest.approx(
        1e6 * busy / 500)
    assert reader("device_us_per_proof")(synthetic([1.0, 2.0])) is None
    assert reader("device_us_per_proof")(
        synthetic([1.0], device=device)) is None
    assert reader("device_us_per_proof")(
        synthetic([1.0, 2.0], device=[("k", 5.0, 6.0)])) is None


def test_msm_least_adds_and_roofline():
    mod = __import__("importlib").import_module
    spec = __import__("importlib.util").util
    s = spec.spec_from_file_location(
        "m", cell.ROOT / "portbench" / "metrics" / "msm_roofline.py")
    m = spec.module_from_spec(s)
    s.loader.exec_module(m)
    del mod
    # 1 entry: at c = 1, 254 windows of one bucket, nothing to add into
    # it, no bucket sum, 253 window additions
    assert m.least_adds(1) == 253
    e = 16640
    want = min(math.ceil(254 / c) * (max(e - 2 ** (c - 1), 0)
                                     + 2 * (2 ** (c - 1) - 1))
               + math.ceil(254 / c) - 1 for c in range(1, 17))
    assert m.least_adds(e) == want
    assert m.ADD_OPS == (11 * 264 + 2 * 32, 11 * 16 + 2 * 16 + 13 * 24)
    assert m.batch_adds(1024, FACTS) == m.least_adds(1024) + \
        m.least_adds(1024 * 15 + 7)
    device = [("void h2v::point_add_kernel<h2v::Limbs16>(", 1.0, 1.4),
              ("(anonymous namespace)::frontier0_kernel(int const*", 0.9,
               1.0),
              ("sqrt_principal_kernel", 1.5, 2.0),
              ("void at::native::_scatter_gather_elementwise_kernel", 2.0,
               2.5), ("Memcpy DtoH", 2.0, 3.0)]
    r = synthetic([1.0, 2.0], sizes=[1024, 1024], device=device)
    adds = 2 * m.batch_adds(1024, FACTS)
    assert m.read(r) == pytest.approx(
        100 * least_seconds(adds * m.ADD_OPS[0], adds * m.ADD_OPS[1]) / 0.5)
    assert m.read(synthetic([1.0])) is None
    # a tampered batch's bisection runs uncounted sub-MSMs: no reading
    tampered = synthetic([1.0, 2.0], sizes=[1024, 1024], tampered=(1,),
                         device=device)
    assert m.read(tampered) is None


def test_sqrt_chain_counts_are_a_real_chain():
    spec = __import__("importlib.util").util
    s = spec.spec_from_file_location(
        "s", cell.ROOT / "portbench" / "metrics" / "sqrt_roofline.py")
    m = spec.module_from_spec(s)
    s.loader.exec_module(m)
    rng = random.Random(1)
    for w in (1, 3, 5):
        for e in ((m.P + 1) // 4, rng.getrandbits(64) | 1):
            sq, mul = m.sliding_counts(e, w)
            got, n_sq, n_mul = power(3, e, w, m.P)
            assert got == pow(3, e, m.P) and (n_sq, n_mul) == (sq, mul)
    imad, alu = m.lane_ops()
    sq, mul = min((m.sliding_counts((m.P + 1) // 4, w) for w in
                   range(1, 11)), key=lambda c: 208 * c[0] + 264 * c[1])
    assert imad == 208 * (sq + 1) + 264 * (mul + 1)
    assert alu == 16 * (sq + mul + 2) + 24


def power(x, e, w, p):
    """Left-to-right sliding-window power, counting its operations."""
    n_sq = n_mul = 0
    table = {1: x}
    if w > 1:
        x2 = x * x % p
        n_sq += 1
        for k in range(3, 1 << w, 2):
            table[k] = table[k - 2] * x2 % p
            n_mul += 1
    bits = bin(e)[2:]
    acc, i = None, 0
    while i < len(bits):
        if bits[i] == "0":
            acc = acc * acc % p
            n_sq += 1
            i += 1
            continue
        j = min(i + w, len(bits))
        while bits[j - 1] == "0":
            j -= 1
        v = int(bits[i:j], 2)
        if acc is None:
            acc = table[v]
        else:
            for _ in range(j - i):
                acc = acc * acc % p
                n_sq += 1
            acc = acc * table[v] % p
            n_mul += 1
        i = j
    return acc, n_sq, n_mul
