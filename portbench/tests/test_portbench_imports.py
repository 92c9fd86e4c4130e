"""What the harness, its metric readers and the reference load, compared
by whole top-level module names."""

import ast
import subprocess
import sys

from portbench import cell

JAX = {"jax", "jaxlib", "flax", "halo2_verifier_tpu"}


def loaded_by(code: str) -> set:
    out = subprocess.run([sys.executable, "-c", code + "\nimport sys\n"
                          "print(' '.join(sorted({m.split('.')[0] for m in "
                          "sys.modules})))"],
                         cwd=cell.ROOT, capture_output=True, text=True,
                         timeout=300, check=True)
    return set(out.stdout.split())


def test_harness_and_readers_load_no_jax():
    code = ("from portbench import run, control, trace\n"
            "import portbench.record\n"
            "for m in run.cellmod.load_spec()['per_layer'] + "
            "run.cellmod.load_spec()['end_to_end']:\n"
            "    run.load_reader(run.cellmod.ROOT, m['name'])\n")
    got = loaded_by(code)
    assert "halo2_verifier_tpu_torch" in got
    assert not got & JAX


def test_reference_loads_nothing_of_either_package():
    got = loaded_by("import portbench.reference.check")
    assert not got & (JAX | {"halo2_verifier_tpu_torch", "torch"})


def test_reference_sources_import_only_the_standard_library_and_itself():
    allowed = {"__future__", "dataclasses", "hashlib", "random", "secrets",
               "struct", "typing"}
    for path in (cell.ROOT / "portbench" / "reference").glob("*.py"):
        for node in ast.walk(ast.parse(path.read_text())):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                if node.level:
                    assert node.level == 1, path
                    continue
                names = [node.module]
            else:
                continue
            for n in names:
                assert n.split(".")[0] in allowed, (path.name, n)
