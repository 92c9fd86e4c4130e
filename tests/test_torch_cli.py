"""The port's command-line tools (halo2_verifier_tpu_torch/cli.py) beside
the JAX package's (halo2_verifier_tpu/cli.py), mirroring
tests/test_cli.py: convert-params and inspect-vk write and print what the
JAX CLI does, byte for byte and line for line; verify (--device cpu, the
plain torch versions of the kernels) gives the JAX CLI's verdict and exit
code on a valid proof and on each probe (tampered instances, the wrong
hash, the wrong multiopen, a truncated proof), never a traceback; without
a card and without --device cpu it refuses to run."""

import pytest
import torch

from halo2_verifier_tpu import cli as jcli
from halo2_verifier_tpu_torch import cli
from halo2_verifier_tpu_torch.prover.circuits import vector_mul_spec
from halo2_verifier_tpu_torch.prover.keygen import keygen
from halo2_verifier_tpu_torch.prover.prove import create_proof
from halo2_verifier_tpu_torch.prover.srs import load_srs
from halo2_verifier_tpu_torch.transcript import TRANSCRIPT_WRITERS


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The plain forest runs many small ops: one intra-op thread keeps it
    from fighting the other test workers for the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def artifacts(tmp_path_factory):
    """The files of tests/test_cli.py, made by the port's prover: the fat
    k=8 SRS, the vector_mul vk, one blake2b x SHPLONK and one keccak256 x
    GWC proof, their instances, and the probes' files."""
    d = tmp_path_factory.mktemp("torch_cli")
    srs = load_srs(8)
    spec, make_assignment = vector_mul_spec(8, 6)
    pk = keygen(spec, srs)
    asg = make_assignment([2] * 6, [5] * 6)
    files = {"srs": srs.to_bytes(), "vk": pk.vk.to_bytes("processed")}
    for hash_name, multiopen in (("blake2b", "shplonk"),
                                 ("keccak256", "gwc")):
        files[f"proof_{multiopen}"] = create_proof(
            pk, [asg], TRANSCRIPT_WRITERS[hash_name](), multiopen=multiopen)
    files["proof_truncated"] = files["proof_shplonk"][:500]
    col = [str(v) for v in asg.instance[0]]
    files["instances"] = ("\n".join(col) + "\n").encode()
    files["instances_bad"] = ("\n".join([str(int(col[0]) + 1)] + col[1:])
                              + "\n").encode()
    paths = {}
    for name, data in files.items():
        paths[name] = d / f"{name}.bin"
        paths[name].write_bytes(data)
    paths["params"] = d / "params.bin"
    assert jcli.main(["convert-params", str(paths["srs"]),
                      str(paths["params"])]) == 0
    return d, {k: str(v) for k, v in paths.items()}


def _run(main, argv, capsys):
    rc = main(argv)
    out = capsys.readouterr()
    return rc, out.out, out.err


def test_convert_params_matches_jax(artifacts, capsys):
    d, p = artifacts
    got = []
    for main in (jcli.main, cli.main):
        out = str(d / "converted.srs")
        rc, text, _ = _run(main, ["convert-params", p["srs"], out], capsys)
        got.append((rc, text, open(out, "rb").read()))
    assert got[1] == got[0]
    rc, text, data = got[1]
    assert rc == 0 and len(data) == 164
    assert "wrote verifier params (k=8)" in text
    # the default output path: <in>.zkverify.srs
    rc, text, _ = _run(cli.main, ["convert-params", p["srs"]], capsys)
    assert rc == 0 and p["srs"][:-len(".bin")] + ".zkverify.srs" in text


def test_inspect_vk_matches_jax(artifacts, capsys):
    _, p = artifacts
    want = _run(jcli.main, ["inspect-vk", p["vk"]], capsys)
    got = _run(cli.main, ["inspect-vk", p["vk"]], capsys)
    assert got == want
    rc, text, _ = got
    assert rc == 0
    assert "k=8" in text and "gates=" in text and "transcript_repr=0x" in text


def _verify_argv(p, proof, instances, *flags):
    return ["verify", p["params"], p["vk"], p[proof],
            "--instances", p[instances], *flags]


@pytest.mark.parametrize("proof,flags", [
    ("proof_shplonk", ()),
    ("proof_gwc", ("--multiopen", "gwc", "--hash", "keccak256")),
])
def test_verify_ok_matches_jax(artifacts, capsys, proof, flags):
    _, p = artifacts
    argv = _verify_argv(p, proof, "instances", *flags)
    assert _run(jcli.main, argv, capsys)[:2] == (0, "OK\n")
    assert _run(cli.main, [*argv, "--device", "cpu"], capsys)[:2] == (
        0, "OK\n")


@pytest.mark.parametrize("probe", ["tampered_instances",
                                   "keccak256_on_blake2b_proof",
                                   "gwc_on_shplonk_proof", "truncated_proof"])
def test_verify_probes_fail_like_jax(artifacts, capsys, probe):
    _, p = artifacts
    argv = {
        "tampered_instances": _verify_argv(p, "proof_shplonk",
                                           "instances_bad"),
        "keccak256_on_blake2b_proof": _verify_argv(
            p, "proof_shplonk", "instances", "--hash", "keccak256"),
        "gwc_on_shplonk_proof": _verify_argv(
            p, "proof_shplonk", "instances", "--multiopen", "gwc"),
        "truncated_proof": _verify_argv(p, "proof_truncated", "instances"),
    }[probe]
    assert _run(jcli.main, argv, capsys)[:2] == (1, "FAIL\n")
    assert _run(cli.main, [*argv, "--device", "cpu"], capsys) == (
        1, "FAIL\n", "")


def test_verify_without_a_card_refuses(artifacts, capsys, monkeypatch):
    """No silent fallback: --device defaults to cuda, and without a card
    verify prints no verdict and exits 2."""
    _, p = artifacts
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    argv = _verify_argv(p, "proof_shplonk", "instances")
    for extra in ([], ["--device", "cuda"]):
        rc, text, err = _run(cli.main, [*argv, *extra], capsys)
        assert (rc, text) == (2, "")
        assert "CUDA" in err
