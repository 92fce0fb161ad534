"""The port imports nothing of JAX and nothing of the JAX package.

An AST scan of every module of ``src/repro_torch/`` and of
``chip_smoke.py`` finds no ``jax*`` and no ``repro``/``repro.*`` import,
and importing the training entry point in a fresh interpreter leaves no
such module in ``sys.modules``.
"""
import ast
import json
import os
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
FILES = sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + [
    ROOT / "chip_smoke.py"]


def _forbidden(name: str) -> bool:
    top = name.split(".")[0]
    return top.startswith("jax") or top == "repro"


def _imports(path: Path) -> list[str]:
    names = []
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            names += [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.append(node.module or "")
        elif (isinstance(node, ast.Call)
              and getattr(node.func, "attr", getattr(node.func, "id", ""))
              in ("import_module", "__import__") and node.args
              and isinstance(node.args[0], ast.Constant)):
            names.append(str(node.args[0].value))
    return names


def test_no_jax_or_reference_imports_in_the_port():
    assert len(FILES) > 20 and all(f.exists() for f in FILES)
    bad = {str(f.relative_to(ROOT)): [n for n in _imports(f)
                                      if _forbidden(n)]
           for f in FILES}
    assert not {f: n for f, n in bad.items() if n}


def test_forbidden_names():
    assert _forbidden("jax") and _forbidden("jax.numpy")
    assert _forbidden("jaxlib") and _forbidden("repro.core")
    assert not _forbidden("repro_torch.core") and not _forbidden("torch")


def test_entry_point_loads_no_jax_module():
    code = ("import json, sys; import repro_torch.launch.train; "
            "import repro_torch.core.simulator; "
            "print(json.dumps(sorted(m for m in sys.modules "
            "if m.split('.')[0].startswith('jax') "
            "or m.split('.')[0] == 'repro')))")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", code], env=env, check=True,
                         capture_output=True, text=True, cwd=ROOT)
    assert json.loads(out.stdout.strip().splitlines()[-1]) == []
