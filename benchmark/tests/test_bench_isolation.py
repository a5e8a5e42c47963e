"""Nothing a run loads is JAX or the JAX package, compared by whole
top-level names, and the reference loads nothing of the program."""

import ast
import subprocess
import sys

from benchmark.core import spec

FORBIDDEN = {"jax", "jaxlib", "flax", "sda_tpu"}


def _in_fresh_process(code: str) -> str:
    prelude = f"import sys\nsys.path.insert(0, {str(spec.ROOT)!r})\n"
    return subprocess.run([sys.executable, "-c", prelude + code], capture_output=True,
                          text=True, check=True, cwd=spec.ROOT).stdout


def test_a_run_loads_no_jax():
    out = _in_fresh_process(
        "from benchmark import run\n"
        "from benchmark.core import driver\n"
        "from benchmark.tests.cells import tiny_cell\n"
        "for kind in ('streaming', 'single'):\n"
        "    driver.run_cell(tiny_cell(kind), 3, 0.01, True, 'cpu')\n"
        "print(sorted({m.split('.')[0] for m in sys.modules}))\n"
        "print(run.forbidden_modules())\n"
    )
    loaded, found = out.strip().splitlines()[-2:]
    assert "sda_tpu_torch" in loaded
    assert found == "[]"
    assert not FORBIDDEN & set(eval(loaded))


def test_the_check_compares_whole_names(monkeypatch):
    from benchmark import run

    monkeypatch.setitem(sys.modules, "sda_tpu_torch_like.ops", None)
    monkeypatch.setitem(sys.modules, "jaxtyping_like", None)
    assert run.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "sda_tpu.fields", None)
    assert run.forbidden_modules() == ["sda_tpu"]


def test_the_reference_loads_nothing_of_the_program():
    out = _in_fresh_process(
        "sys.modules['sda_tpu_torch'] = None\n"
        "from benchmark.reference.round import ReferenceRound\n"
        "from benchmark.tests.cells import tiny_cell\n"
        "ref = ReferenceRound(tiny_cell('streaming'), 4, 'cpu')\n"
        "print(len(ref.answer(0)))\n"
        "print([m for m, v in sys.modules.items() if m.startswith('sda_tpu') and v])\n"
    )
    assert out.strip().splitlines()[-2:] == ["30", "[]"]


def test_reference_sources_import_no_program():
    for path in (spec.BENCH_DIR / "reference").glob("*.py"):
        tree = ast.parse(path.read_text())
        names = [a.name for n in ast.walk(tree) if isinstance(n, ast.Import) for a in n.names]
        names += [n.module for n in ast.walk(tree) if isinstance(n, ast.ImportFrom) and n.module]
        assert not [n for n in names if n.split(".")[0].startswith("sda_tpu")], path
