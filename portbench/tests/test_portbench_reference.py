"""The plain reference on a few proofs of each configuration: valid proofs
pass, a tampered proof is found, a malformed one is rejected."""

import pytest

from portbench import cell, judge
from portbench.tests.conftest import spec_with_parked


@pytest.mark.parametrize("config", ["k14_mac_shplonk", "k9_mac_keccak_gwc"])
def test_reference_passes_valid_and_finds_tampered(config):
    spec = spec_with_parked()
    cfg = cell.load_config(spec, config)
    ref = judge.reference_for(cfg, 1)
    items = {i: (cfg.proofs[i], cfg.instances[i]) for i in range(4)}
    items[("tampered", 2)] = cell.tampered_item(items[2])
    items[("cut", 1)] = (cfg.proofs[1][:len(cfg.proofs[1]) // 2],
                         cfg.instances[1])
    ref.replay_items(items)
    assert ref.duals[("cut", 1)] is None
    keys = [0, 1, ("tampered", 2), 3, ("cut", 1)]
    # one group: the split must isolate the tampered item
    got = ref.verdicts([keys])
    assert got == {0: True, 1: True, ("tampered", 2): False, 3: True,
                   ("cut", 1): False}


def test_reference_refuses_a_key_other_than_the_packs():
    spec = spec_with_parked()
    cfg = cell.load_config(spec, "k9_mac_keccak_gwc")
    cfg.vk_sha256 = "0" * 64
    with pytest.raises(ValueError):
        judge.reference_for(cfg, 1)
