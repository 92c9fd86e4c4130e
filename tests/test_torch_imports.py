"""The PyTorch port stands alone: no module of halo2_verifier_tpu_torch,
and neither root script (chip_smoke.py, sweep_kernels.py), imports jax or
anything of the JAX package halo2_verifier_tpu (checked on the source, so
it holds on machines where jax is absent)."""

import ast
import os
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.join(REPO, "halo2_verifier_tpu_torch")
FORBIDDEN = ("jax", "jaxlib", "halo2_verifier_tpu")


def _sources():
    out = [os.path.join(REPO, name)
           for name in ("chip_smoke.py", "sweep_kernels.py")]
    for root, _dirs, files in os.walk(PKG):
        out += [os.path.join(root, f) for f in files if f.endswith(".py")]
    return sorted(out)


def _imported_roots(path):
    with open(path) as f:
        tree = ast.parse(f.read(), filename=path)
    roots = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            roots.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            roots.add(node.module.split(".")[0])
        elif (isinstance(node, ast.Call)
              and getattr(node.func, "id", None) == "__import__"
              and node.args and isinstance(node.args[0], ast.Constant)):
            roots.add(str(node.args[0].value).split(".")[0])
    return roots


@pytest.mark.parametrize("path", _sources(),
                         ids=lambda p: os.path.relpath(p, REPO))
def test_no_jax_import(path):
    bad = _imported_roots(path) & set(FORBIDDEN)
    assert not bad, f"{os.path.relpath(path, REPO)} imports {sorted(bad)}"


def test_importing_the_port_loads_no_jax_package_module():
    mods = sorted(
        os.path.relpath(p, REPO)[:-3].replace(os.sep, ".")
        .replace(".__init__", "")
        for p in _sources() if p.startswith(PKG)
    )
    code = (
        "import sys\n"
        + "".join(f"import {m}\n" for m in mods)
        + "bad = [m for m in sys.modules if m == 'halo2_verifier_tpu' "
        "or m.startswith('halo2_verifier_tpu.')]\n"
        "assert not bad, bad\n"
    )
    subprocess.run([sys.executable, "-c", code], cwd=REPO, check=True,
                   timeout=300)


def test_sources_cover_every_port_module():
    """The walk above reaches the modules a slice adds (the device
    pairing, the configuration, the device policy, the CLI, the L1
    helpers, upstream ingestion and the test prover)."""
    rel = {os.path.relpath(p, REPO) for p in _sources()}
    for name in ("ops/pairing.py", "config.py", "utils/device.py",
                 "__init__.py", "cli.py", "ops/arith.py",
                 "protocol/expression.py", "prover/__init__.py",
                 "prover/circuit.py", "prover/circuits.py",
                 "prover/fixtures.py", "prover/keygen.py", "prover/poly.py",
                 "prover/prove.py", "prover/srs.py"):
        assert os.path.join("halo2_verifier_tpu_torch", name) in rel
