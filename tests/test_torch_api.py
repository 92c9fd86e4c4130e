"""PyTorch port, public surface (halo2_verifier_tpu_torch/__init__.py,
config.py): the export list equals the JAX package's, every name from the
port's own modules; VerifierConfig has exactly the reference's fields and
defaults and builds the port's BatchVerifier on the device it is given;
neither takes a forest_dispatch; a mesh of D devices needs a live process
group of D ranks."""

import dataclasses

import pytest

import halo2_verifier_tpu as ref
import halo2_verifier_tpu_torch as port
from halo2_verifier_tpu.config import VerifierConfig as RefConfig
from halo2_verifier_tpu_torch.ops.constants import G1_GEN, G2_GEN
from halo2_verifier_tpu_torch.parallel import orchestrator


def _params():
    return port.ParamsKZG(8, 256, G1_GEN, G2_GEN, G2_GEN)


def test_export_surface_matches_reference():
    assert sorted(port.__all__) == sorted(ref.__all__)
    for name in port.__all__:
        obj = getattr(port, name)
        assert obj.__module__.startswith("halo2_verifier_tpu_torch."), name
    assert int(port.Rotation.prev()) == -1
    assert (port.Blind(3) * port.Blind(4)).value == 12
    bv = port.BatchVerifier(_params(), None, device="cpu")
    assert isinstance(bv, orchestrator.BatchVerifier)


def test_verifier_config_fields_and_defaults_match_reference():
    def fields(cls):
        return [(f.name, f.default) for f in dataclasses.fields(cls)]

    assert fields(port.VerifierConfig) == fields(RefConfig)


def test_forest_dispatch_is_not_an_argument():
    """The forest MSM has one dispatch: neither the verifier nor its
    configuration takes a forest_dispatch."""
    with pytest.raises(TypeError, match="forest_dispatch"):
        port.BatchVerifier(_params(), None, device="cpu",
                           forest_dispatch="packed")
    with pytest.raises(TypeError, match="forest_dispatch"):
        port.VerifierConfig(forest_dispatch="packed")


@pytest.mark.parametrize("strategy", ["single", "accumulator"])
@pytest.mark.parametrize("pairing", ["host", "device"])
def test_make_verifier_builds_the_configured_verifier(strategy, pairing):
    cfg = port.VerifierConfig(multiopen="gwc", hash="keccak256",
                              strategy=strategy, pairing=pairing)
    bv = cfg.make_verifier(_params(), None, device="cpu", msm="host")
    assert isinstance(bv, orchestrator.BatchVerifier)
    assert (bv.multiopen, bv.hash_name, bv.strategy, bv.pairing, bv.msm,
            bv.device.type) == ("gwc", "keccak256", strategy, pairing,
                                "host", "cpu")
    assert cfg.make_verifier(_params(), None, device="cpu").msm == "forest"


def test_mesh_shape_raises():
    """A mesh of two devices needs a live process group of two ranks
    (tests/test_torch_dist.py forms one); without it the config raises
    and says how to launch the ranks."""
    with pytest.raises(RuntimeError, match="process group of 2 ranks"):
        port.VerifierConfig(mesh_shape=(2,)).make_verifier(
            _params(), None, device="cpu")
