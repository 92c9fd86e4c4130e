"""The traffic a seed makes: the same seed the same batches."""

import statistics

import pytest

from portbench import cell
from portbench.tests.conftest import spec_with_parked


def stream_of(workload, seed):
    spec = spec_with_parked()
    wl = cell.workload(spec, workload)
    cfg = cell.load_config(spec, wl["config"])
    return cfg, cell.build_stream(cfg, cell.load_traffic(wl["traffic"]),
                                  seed)


def shape(stream):
    return [[(b.size, sorted(b.tampered.items())) for b in part]
            for part in (stream.cycle, stream.warm, stream.probe)]


@pytest.mark.parametrize("workload", ["k14_mac_shplonk.stream_1024",
                                      "k14_mac_shplonk.tamper_1in4",
                                      "k9_mac_keccak_gwc.ragged_64-1024",
                                      "k9_mac_keccak_gwc.stream_256"])
def test_same_seed_same_batches(workload):
    big = 2 ** 31 + 12345
    _cfg, a = stream_of(workload, big)
    _cfg, b = stream_of(workload, big)
    assert shape(a) == shape(b)
    for x, y in zip(a.cycle, b.cycle):
        assert x.proofs == y.proofs
    _cfg, c = stream_of(workload, big + 1)
    assert shape(a) != shape(c)


def test_tamper_every_fourth_batch_at_a_seeded_position():
    cfg, s = stream_of("k14_mac_shplonk.tamper_1in4", 7)
    n = len(cfg.proofs)
    assert len(s.cycle) % 4 == 0
    for i, b in enumerate(s.cycle):
        assert b.size == 1024
        assert len(b.tampered) == (1 if i % 4 == 3 else 0)
        for pos, key in b.tampered.items():
            assert key == ("tampered", pos % n)
            proof, inst = b.proofs[pos]
            p0, i0 = cfg.proofs[pos % n], cfg.instances[pos % n]
            assert proof == p0 and inst[0][0] == (i0[0][0] + 1) % cell.R
            assert inst[0][1:] == i0[0][1:]
        for p in (0, 1, 500, 1023):
            if p not in b.tampered:
                assert b.proofs[p] == (cfg.proofs[p % n],
                                       cfg.instances[p % n])
    assert not s.probe and s.warm == s.cycle[:4]


def test_ragged_cycles_shuffle_sixteen_sizes_with_mean_544():
    _cfg, s = stream_of("k9_mac_keccak_gwc.ragged_64-1024", 11)
    sizes = [b.size for b in s.cycle]
    assert statistics.mean(sizes) == 544
    cycles = [sizes[i:i + 16] for i in range(0, len(sizes), 16)]
    assert len(cycles) >= 2 and len({tuple(c) for c in cycles}) > 1
    for c in cycles:
        assert sorted(c) == list(range(64, 1025, 64))
    assert s.warm == s.cycle[:4]
    # the MSM pinned to a 1,024-proof batch's padded size: 1,024 x 20
    # right-hand terms per proof + 6 shared, rounded up to 256 entries
    pad = cell.load_traffic("k9_mac_keccak_gwc.ragged_64-1024"
                            .split(".")[1])["stream"]["pad_to"]
    assert pad == -(-(1024 * 20 + 6) // 256) * 256


def test_probe_has_one_tampered_proof_in_each_half():
    _cfg, s = stream_of("k14_mac_shplonk.stream_1024", 3)
    (probe,) = s.probe
    lo, hi = sorted(probe.tampered)
    assert lo < 512 <= hi < 1024
    assert all(not b.tampered for b in s.cycle)


def test_expected_answer_names_the_tampered_positions():
    _cfg, s = stream_of("k14_mac_shplonk.stream_1024", 3)
    (probe,) = s.probe
    valid = {k: not isinstance(k, tuple) for k in s.items}
    assert cell.expected(probe, valid) == (False, sorted(probe.tampered))
    assert cell.expected(s.cycle[0], valid) == (True, [])
