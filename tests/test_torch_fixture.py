"""The PyTorch port's committed k=14 fixture
(halo2_verifier_tpu_torch/data/k14_mac_fixture.npz) against a fresh
derivation through the JAX package's test prover, and the port's params
and vk loaders against the reference's codecs.

The fixture stores the derived verifying key and the public inputs of
every pack seed, so the main path reads them without a k=14 keygen (the
port's own prover derives the same instances:
tests/test_torch_prover.py). Regenerate with

    python tests/test_torch_fixture.py
"""

import hashlib
import os
import sys

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if REPO not in sys.path:
    sys.path.insert(0, REPO)

K, ROWS, N_PUB = 14, 8192, 32
FIXTURE = os.path.join(REPO, "halo2_verifier_tpu_torch", "data",
                       "k14_mac_fixture.npz")
PACK = os.path.join(REPO, "params", "k14_mac_pack.npz")


def _derive():
    """(srs, vk, make_assignment) from the reference's test prover."""
    from halo2_verifier_tpu.prover.circuits import mac_range_spec
    from halo2_verifier_tpu.prover.keygen import keygen
    from halo2_verifier_tpu.prover.srs import load_srs

    srs = load_srs(K)
    spec, mk = mac_range_spec(K, ROWS, N_PUB)
    return srs, keygen(spec, srs).vk, mk


def _instance_bytes(mk, seed):
    """One proof's instance column as (N_PUB, 32) little-endian bytes."""
    col = mk(int(seed)).instance[0]
    buf = b"".join(int(v).to_bytes(32, "little") for v in col)
    return np.frombuffer(buf, dtype=np.uint8).reshape(len(col), 32)


def generate(path=FIXTURE):
    _srs, vk, mk = _derive()
    with np.load(PACK) as z:
        seeds = z["seeds"]
        want = str(z["vk_sha256"])
    vk_bytes = vk.to_bytes()
    assert hashlib.sha256(vk_bytes).hexdigest() == want, "pack vk drifted"
    np.savez_compressed(
        path,
        vk=np.frombuffer(vk_bytes, dtype=np.uint8),
        seeds=seeds,
        instances=np.stack([_instance_bytes(mk, s) for s in seeds]),
    )


def test_fixture_matches_fresh_derivation():
    srs, vk, mk = _derive()
    with np.load(FIXTURE) as fx:
        vk_bytes = fx["vk"].tobytes()
        seeds = fx["seeds"]
        inst = fx["instances"]
    assert vk_bytes == vk.to_bytes()
    assert len(vk_bytes) == 587
    for i in (0, 101, len(seeds) - 1):
        np.testing.assert_array_equal(inst[i], _instance_bytes(mk, seeds[i]))

    from halo2_verifier_tpu_torch import weights

    params, pvk, items = weights.load_k14_mac_fixture()
    assert len(items) == 256
    assert params.to_bytes() == srs.verifier_params().to_bytes()
    assert pvk.to_bytes() == vk_bytes
    assert items[5][1] == [list(mk(int(seeds[5])).instance[0])]


def test_codec_loaders_match_reference(vm_proofs_k8):
    params, vk, _batch = vm_proofs_k8
    from halo2_verifier_tpu.protocol.vk import RAW_BYTES
    from halo2_verifier_tpu_torch import weights

    for fmt in ("processed", RAW_BYTES):
        p = weights.params_from_reference(params.to_bytes(fmt), fmt)
        assert p.to_bytes(fmt) == params.to_bytes(fmt)
        v = weights.vk_from_reference(vk.to_bytes(fmt), fmt)
        assert v.to_bytes(fmt) == vk.to_bytes(fmt)
        assert v.content_digest() == vk.content_digest()


def test_load_rejects_drifted_vk(tmp_path):
    from halo2_verifier_tpu_torch import weights

    with np.load(FIXTURE) as fx:
        vk = fx["vk"].copy()
        vk[-1] ^= 1
        bad = tmp_path / "bad.npz"
        np.savez(bad, vk=vk, seeds=fx["seeds"], instances=fx["instances"])
    try:
        weights.load_k14_mac_fixture(fixture_path=str(bad))
    except ValueError as e:
        assert "sha256" in str(e)
    else:
        raise AssertionError("a drifted vk must be rejected")


if __name__ == "__main__":
    generate()
    print(f"wrote {FIXTURE}")
