"""What a run loads: no module whose whole top-level name is jax, jaxlib,
flax or audfprint_tpu (the port's own name begins with the JAX
package's, so names are compared whole), and a reference that loads
nothing of the program."""

import ast
import json
import os
import subprocess
import sys

from portbench import procs

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(os.path.dirname(HERE))


def _tops(code: str) -> set:
    env = dict(os.environ, PYTHONPATH=ROOT, CUDA_VISIBLE_DEVICES="")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=600,
                         check=True).stdout
    return set(json.loads(out.strip().splitlines()[-1]))


def test_forbidden_names_are_compared_whole(monkeypatch):
    monkeypatch.setitem(sys.modules, "audfprint_tpu_x", sys)
    monkeypatch.setitem(sys.modules, "jaxlibrary", sys)
    assert procs.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "jax.numpy", sys)
    assert procs.forbidden_modules() == ["jax.numpy"]


def test_a_run_up_to_the_card_loads_no_jax():
    tops = _tops(
        "import sys, json\n"
        "from portbench import run, drive, judge, trace, control\n"
        "from portbench.reference import analyze, table\n"
        "files = run.cell_files(run.manifest(), 'c2-1k.ingest')\n"
        "for m in files['per_layer'] + files['end_to_end']:\n"
        "    run.reader(m['name'])\n"
        "print(run.check_chip(1))\n"
        "print(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))")
    assert not tops & set(procs.FORBIDDEN)


def test_a_whole_tiny_run_loads_no_jax():
    tops = _tops(
        "import sys, json\n"
        "from portbench.tests.conftest import tiny, run_tiny\n"
        "line = run_tiny(tiny('c2-1k.ingest'), seconds=0.5)\n"
        "assert line['correct'], line\n"
        "print(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))")
    assert "audfprint_torch" in tops
    assert not tops & set(procs.FORBIDDEN)


def test_the_reference_loads_nothing_of_the_program():
    tops = _tops(
        "import sys, json\n"
        "from portbench.reference import analyze, table\n"
        "print(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))")
    assert not tops & (set(procs.FORBIDDEN) | {"audfprint_torch"})


def test_the_reference_imports_only_numpy_and_torch():
    ref = os.path.join(ROOT, "portbench", "reference")
    for f in os.listdir(ref):
        if not f.endswith(".py"):
            continue
        with open(os.path.join(ref, f)) as fh:
            tree = ast.parse(fh.read())
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                names = [node.module or ""]
            else:
                continue
            for n in names:
                assert n.split(".")[0] in ("__future__", "math", "typing",
                                           "numpy", "torch"), (f, n)
