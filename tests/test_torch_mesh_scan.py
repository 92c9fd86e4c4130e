"""PyTorch port, the sharded scan MSMs (halo2_verifier_tpu_torch/parallel/
mesh.py sharded_window_totals_presorted and sharded_window_totals) on
three gloo CPU ranks: a mesh of 3 divides neither the 32 windows nor the
64 of two groups, so the orchestrator falls through to the presorted scan
and pads the sorted entries with identity entries to a multiple of 3. In
both limb formats ("u16": K1 + K2, "f8": K4 + K5) the combined points
equal the port's single-device scan and the exact host MSM; so does the
plain sharded scan (sharded_msm over pad_entries). The JAX mesh at D = 3
compiles for many minutes (heavy_compile in tests/test_mesh_e2e.py), so
the host oracle is the comparison here."""

import numpy as np
import pytest
import torch

from halo2_verifier_tpu.ops import hostcurve as jhc
from halo2_verifier_tpu_torch.ops import msm_scan
from halo2_verifier_tpu_torch.ops.constants import G1_GEN, P, R
from halo2_verifier_tpu_torch.ops.field import FQ
from halo2_verifier_tpu_torch.ops.limbs import ints_to_limbs
from halo2_verifier_tpu_torch.ops.msm import combine_window_totals_grouped

from torch_ranks import start_ranks, wait_ranks

SIZES = [7, 10]  # 17 * 32 = 544 sorted entries: 1 short of a multiple of 3
PLAIN_N = 11     # the plain sharded scan's entries, padded to 12

WORKER = r"""
import json, os, sys
import numpy as np
import torch
torch.set_num_threads(1)
from halo2_verifier_tpu_torch.ops.constants import G1_GEN, G2_GEN
from halo2_verifier_tpu_torch.parallel import dist
from halo2_verifier_tpu_torch.parallel import mesh as pmesh
from halo2_verifier_tpu_torch.parallel.orchestrator import BatchVerifier
from halo2_verifier_tpu_torch.protocol.kzg import ParamsKZG

out = sys.argv[1]
assert dist.init_distributed(device="cpu", timeout=120)
mesh = pmesh.make_mesh(3, device="cpu")
z = np.load(os.path.join(out, "case.npz"))
sizes = [int(v) for v in z["sizes"]]
params = ParamsKZG(8, 256, G1_GEN, G2_GEN, G2_GEN)
res = {}
for backend in ("u16", "f8"):
    bv = BatchVerifier(params, None, mesh=mesh, limb_backend=backend,
                       msm="scan" if backend == "f8" else "forest")
    handle = bv._dispatch_limbs(z["s"], z["x"], z["y"], sizes)
    res[backend] = [handle[0], [None if p is None else [str(c) for c in p]
                                for p in bv._collect_pair(handle)]]
s, x, y = pmesh.pad_entries(z["ps"], z["px"], z["py"], mesh.size)
pt = pmesh.sharded_msm(mesh, s, x, y)
res["plain"] = [int(s.shape[0]), None if pt is None else [str(c) for c in pt]]
with open(os.path.join(out, f"rank{mesh.rank}.json"), "w") as f:
    json.dump(res, f)
dist.shutdown()
print(f"SCAN_OK rank={mesh.rank}", flush=True)
"""


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _points(n, seed):
    rng = np.random.RandomState(seed)
    scalars = [int.from_bytes(rng.bytes(32), "little") % R for _ in range(n)]
    pool = [jhc.g1_mul(G1_GEN, 5 + 3 * i) for i in range(5)]
    points = [None if i % 6 == 5 else pool[i % 5] for i in range(n)]
    return scalars, points


def _json_points(pts):
    return [None if p is None else [str(c) for c in p] for p in pts]


@pytest.fixture(scope="module")
def three_ranks(tmp_path_factory):
    """The ranks' combined points, the single-device scan's in both limb
    formats (computed here while the ranks run) and the host MSM's."""
    import json

    work = tmp_path_factory.mktemp("mesh3")
    scalars, points = _points(sum(SIZES), 13)
    s = ints_to_limbs(scalars)
    x = ints_to_limbs([0 if p is None else p[0] for p in points])
    y = ints_to_limbs([0 if p is None else p[1] for p in points])
    pscalars, ppoints = _points(PLAIN_N, 17)
    r = FQ.mont_r
    np.savez(work / "case.npz", s=s, x=x, y=y, sizes=np.asarray(SIZES),
             ps=ints_to_limbs(pscalars),
             px=ints_to_limbs([0 if p is None else p[0] * r % P
                               for p in ppoints]),
             py=ints_to_limbs([0 if p is None else p[1] * r % P
                               for p in ppoints]))
    procs = start_ranks(WORKER, 3, work)
    try:
        idx, keys, levels = msm_scan.host_plan(s, SIZES)
        single = {
            backend: _json_points(combine_window_totals_grouped(
                msm_scan.msm_window_totals_grouped(
                    x, y, idx, keys, 2, levels, torch.device("cpu"),
                    backend=backend).numpy(), 2))
            for backend in ("u16", "f8")
        }
    finally:
        outs = wait_ranks(procs, work, timeout=400)
    for rank, out in enumerate(outs):
        assert f"SCAN_OK rank={rank}" in out, out
    ranks = [json.loads((work / f"rank{k}.json").read_text())
             for k in range(3)]
    host = _json_points([jhc.g1_msm(scalars[:7], points[:7]),
                         jhc.g1_msm(scalars[7:], points[7:])])
    plain = _json_points([jhc.g1_msm(pscalars, ppoints)])[0]
    return ranks, single, host, plain


@pytest.mark.parametrize("backend", ["u16", "f8"])
def test_scan_kind_equals_single_device_and_host_msm(three_ranks, backend):
    ranks, single, host, _plain = three_ranks
    for res in ranks:
        kind, pts = res[backend]
        assert kind == "sharded_grouped"
        assert pts == single[backend] == host


def test_plain_sharded_scan_equals_host_msm(three_ranks):
    ranks, _single, _host, plain = three_ranks
    for res in ranks:
        assert res["plain"] == [12, plain]
