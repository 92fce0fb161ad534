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
    port = ROOT / "src" / "repro_torch"
    for mod in ("models/ssm.py", "kernels/ssm_scan/ops.py",
                "kernels/ssm_scan/kernel.py", "kernels/ssm_scan/ref.py",
                "configs/hymba_1_5b.py", "configs/falcon_mamba_7b.py",
                "checkpoint/ckpt.py", "checkpoint/__init__.py",
                "serve/engine.py", "serve/weights.py", "serve/cache.py",
                "serve/scheduler.py", "serve/traffic.py",
                "launch/serve.py", "configs/llama3_8b.py",
                "models/moe.py", "configs/olmo_1b.py",
                "configs/qwen2_5_3b.py", "configs/deepseek_7b.py",
                "configs/phi3_5_moe_42b_a6_6b.py",
                "configs/deepseek_v2_236b.py", "analysis/__init__.py",
                "analysis/__main__.py", "analysis/diagnostics.py",
                "analysis/planlint.py", "analysis/runner.py",
                "analysis/torchlint.py"):
        assert port / mod in FILES
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
            "import repro_torch.core.runtime; "
            "import repro_torch.checkpoint; "
            "import repro_torch.launch.serve; "
            "import repro_torch.kernels.rfast_update.ops; "
            "import repro_torch.kernels.ssm_scan.ops; "
            "import repro_torch.models.ssm; "
            "import repro_torch.models.moe; "
            "import repro_torch.configs.deepseek_v2_236b; "
            "import repro_torch.configs.hymba_1_5b; "
            "import repro_torch.configs.falcon_mamba_7b; "
            "import repro_torch.analysis.runner; "
            "import repro_torch.analysis.__main__; "
            "print(json.dumps(sorted(m for m in sys.modules "
            "if m.split('.')[0].startswith('jax') "
            "or m.split('.')[0] == 'repro')))")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", code], env=env, check=True,
                         capture_output=True, text=True, cwd=ROOT)
    assert json.loads(out.stdout.strip().splitlines()[-1]) == []
