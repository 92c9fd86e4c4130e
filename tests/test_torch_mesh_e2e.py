"""PyTorch port, end-to-end verification on a mesh: BatchVerifier(mesh=...)
on four gloo CPU ranks over the k=8 vector_mul pack, mirroring
tests/test_mesh_e2e.py. Under the same deterministic isolation weights
every sharded kind (windows by default, the point-sharded forest and the
presorted scan where forced) gives the JAX package's single-chip
accumulator points exactly; verify is ok; a tampered instance is
localized to the JAX package's index; verify_stream gives the JAX
package's verdicts. Without rng=, the four ranks draw identical isolation
weights (rank 0's seed, broadcast), fresh for each verifier."""

import json
import os
import pickle

import pytest

from halo2_verifier_tpu.ops.constants import R

from torch_ranks import run_ranks

N_RANKS = 4

WORKER = r"""
import json, os, pickle, sys
import torch
torch.set_num_threads(1)
from halo2_verifier_tpu_torch import VerifierConfig, weights
from halo2_verifier_tpu_torch.ops.constants import R
from halo2_verifier_tpu_torch.parallel import dist
from halo2_verifier_tpu_torch.parallel import mesh as pmesh
from halo2_verifier_tpu_torch.parallel.orchestrator import BatchVerifier

out = sys.argv[1]
assert dist.init_distributed(device="cpu", timeout=120)
mesh = pmesh.make_mesh(%(n)d, device="cpu")
with open(os.path.join(out, "case.pkl"), "rb") as f:
    case = pickle.load(f)
params = weights.params_from_reference(case["params"])
vk = weights.vk_from_reference(case["vk"])
proofs, bad = case["proofs"], case["bad"]


def lcg(seed=0x5DEECE66D):
    state = {"x": seed}

    def rng():
        state["x"] = (6364136223846793005 * state["x"]
                      + 1442695040888963407) %% (1 << 64)
        return 1 + state["x"] %% (R - 1)

    return rng


def spy(bv):
    seen = []
    orig = bv._dispatch_limbs

    def wrapper(*a, **k):
        h = orig(*a, **k)
        seen.append(h[0])
        return h

    bv._dispatch_limbs = wrapper
    return seen


def pts(p):
    return [None if q is None else [str(c) for c in q] for q in p]


g = lcg()
w = [g() for _ in proofs]
res = {"points": {}}
for shard in (None, "forest", "scan"):
    bv = BatchVerifier(params, vk, mesh=mesh, mesh_shard=shard)
    seen = spy(bv)
    res["points"][str(shard)] = [seen, pts(bv._eval_combined(bv.replay(proofs),
                                                             w))]
bv = BatchVerifier(params, vk, mesh=mesh, rng=lcg())
seen = spy(bv)
ok = bv.verify(proofs, localize=False)
res["verify"] = [ok.ok, ok.num_proofs, list(seen)]
r = bv.verify(bad)
res["bad"] = [r.ok, r.failed_indices]
rs = list(bv.verify_stream(iter([proofs, bad, proofs])))
res["stream"] = [[x.ok for x in rs], [x.failed_indices for x in rs]]
res["weights"] = [[str(BatchVerifier(params, vk, mesh=mesh)._rng())
                   for _ in range(3)] for _ in range(2)]
bv = VerifierConfig(mesh_shape=(%(n)d,)).make_verifier(params, vk,
                                                       device="cpu")
res["config_mesh"] = [bv.mesh.size, bv.mesh.rank, bv.decomp]
with open(os.path.join(out, f"rank{mesh.rank}.json"), "w") as f:
    json.dump(res, f)
dist.shutdown()
print(f"E2E_OK rank={mesh.rank}", flush=True)
""" % {"n": N_RANKS}


def _lcg_rng(seed=0x5DEECE66D):
    """tests/test_mesh_e2e.py's deterministic isolation-weight stream."""
    state = {"x": seed}

    def rng():
        state["x"] = (6364136223846793005 * state["x"] + 1442695040888963407
                      ) % (1 << 64)
        return 1 + state["x"] % (R - 1)

    return rng


def _pts(p):
    return [None if q is None else [str(c) for c in q] for q in p]


@pytest.fixture(scope="module")
def four_ranks(vm_proofs_k8, tmp_path_factory):
    """The ranks' results beside the JAX single-chip orchestrator's on its
    exact host MSM (H2V_MSM=host: the affine accumulator points are the
    same group elements whichever exact MSM computes them)."""
    from halo2_verifier_tpu.parallel.orchestrator import BatchVerifier

    params, vk, proofs = vm_proofs_k8
    bad = list(proofs)
    bad[1] = (bad[1][0], [[(v + 1) % R for v in bad[1][1][0]]])
    work = tmp_path_factory.mktemp("mesh4")
    with open(work / "case.pkl", "wb") as f:
        pickle.dump({"params": params.to_bytes(), "vk": vk.to_bytes(),
                     "proofs": proofs, "bad": bad}, f)
    outs = run_ranks(WORKER, N_RANKS, work, timeout=400)
    for r, out in enumerate(outs):
        assert f"E2E_OK rank={r}" in out, out
    ranks = [json.loads((work / f"rank{r}.json").read_text())
             for r in range(N_RANKS)]

    old = os.environ.get("H2V_MSM")
    os.environ["H2V_MSM"] = "host"
    try:
        g = _lcg_rng()
        weights = [g() for _ in proofs]
        one = BatchVerifier(params, vk)
        ref_points = _pts(one._eval_combined(one.replay(proofs), weights))
        ref = BatchVerifier(params, vk, rng=_lcg_rng())
        verdicts = [ref.verify(proofs, localize=False), ref.verify(bad)]
    finally:
        if old is None:
            os.environ.pop("H2V_MSM", None)
        else:
            os.environ["H2V_MSM"] = old
    return ranks, ref_points, verdicts


@pytest.mark.parametrize("shard,kind", [
    ("None", "sharded_windows"), ("forest", "sharded_forest"),
    ("scan", "sharded_grouped")])
def test_mesh_accumulator_points_match_jax_single_chip(four_ranks, shard,
                                                       kind):
    ranks, ref_points, _v = four_ranks
    for res in ranks:
        seen, points = res["points"][shard]
        assert seen == [kind]
        assert points == ref_points


def test_mesh_verify_and_localize_match_jax(four_ranks):
    ranks, _p, (ok, bad) = four_ranks
    assert ok.ok and not bad.ok and bad.failed_indices == [1]
    for res in ranks:
        assert res["verify"] == [True, 3, ["sharded_windows"]]
        assert res["bad"] == [bad.ok, bad.failed_indices]


def test_mesh_verify_stream_verdicts(four_ranks):
    """A failing batch between two good ones: the stream localizes it on
    the dispatching thread, in the same order on every rank."""
    ranks, _p, (ok, bad) = four_ranks
    for res in ranks:
        assert res["stream"] == [[ok.ok, bad.ok, ok.ok],
                                 [[], bad.failed_indices, []]]


def test_ranks_draw_identical_isolation_weights(four_ranks):
    ranks, _p, _v = four_ranks
    draws = [res["weights"] for res in ranks]
    assert all(d == draws[0] for d in draws)
    first, second = draws[0]
    assert first != second  # a fresh seed for each verifier
    assert all(0 < int(v) < R for v in first + second)


def test_verifier_config_builds_the_mesh(four_ranks):
    ranks, _p, _v = four_ranks
    for r, res in enumerate(ranks):
        assert res["config_mesh"] == [N_RANKS, r, False]
