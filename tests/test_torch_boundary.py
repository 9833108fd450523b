"""The port stands alone: importing it loads neither JAX nor the JAX package."""
import ast
import os
import pathlib
import shutil
import subprocess
import sys

import pytest

ROOT = pathlib.Path(__file__).resolve().parent.parent
PORT = ROOT / "src" / "repro_torch"


def _env():
    env = dict(os.environ)
    env["PYTHONPATH"] = str(ROOT / "src")
    return env


def test_import_loads_no_jax_and_no_repro():
    code = ("import sys, repro_torch, repro_torch.core, repro_torch.kernels\n"
            "import repro_torch.models, repro_torch.configs, "
            "repro_torch.egress, repro_torch.obs, repro_torch.online, "
            "repro_torch.online.scenario, repro_torch.fleet, "
            "repro_torch.models.moe, repro_torch.models.whisper, "
            "repro_torch.models.rglru, repro_torch.models.xlstm, "
            "repro_torch.serve, repro_torch.train, "
            "repro_torch.train.optim, repro_torch.train.trainer, "
            "repro_torch.train.checkpoint, repro_torch.train.data, "
            "repro_torch.train.driver, repro_torch.parallel, "
            "repro_torch.launch, repro_torch.launch.dryrun, "
            "repro_torch.launch.report\n"
            "import torch.distributed as dist\n"
            "bad = sorted(m for m in sys.modules if m.startswith('jax') or "
            "m == 'repro' or m.startswith('repro.'))\n"
            "if dist.is_initialized():\n"
            "    bad.append('a process group was started')\n"
            "print(bad)\n"
            "sys.exit(1 if bad else 0)\n")
    r = subprocess.run([sys.executable, "-c", code], env=_env(),
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stdout + r.stderr


@pytest.mark.parametrize("path", sorted(str(p.relative_to(ROOT)) for p in
                                        PORT.rglob("*.py")) + ["chip_smoke.py"])
def test_source_imports_no_jax_and_no_repro(path):
    tree = ast.parse((ROOT / path).read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            names = [node.module or ""] if node.level == 0 else []
        else:
            continue
        for name in names:
            top = name.split(".")[0]
            assert top not in ("jax", "jaxlib", "repro"), f"{path}: {name}"


def test_chip_smoke_fails_without_a_card():
    """Where torch sees no card the script exits non-zero and prints no
    result line."""
    code = ("import runpy, sys, torch\n"
            "torch.cuda.is_available = lambda: False\n"
            "sys.argv = ['chip_smoke.py']\n"
            "runpy.run_path('chip_smoke.py', run_name='__main__')\n")
    r = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=_env(),
                       capture_output=True, text=True, timeout=120)
    assert r.returncode != 0
    assert '"ok": true' not in r.stdout


def test_chip_smoke_fails_outside_the_repo(tmp_path):
    shutil.copy(ROOT / "chip_smoke.py", tmp_path / "chip_smoke.py")
    env = dict(os.environ)
    env.pop("PYTHONPATH", None)
    r = subprocess.run([sys.executable, "chip_smoke.py"], cwd=tmp_path,
                       env=env, capture_output=True, text=True, timeout=120)
    assert r.returncode != 0
    assert '"ok": true' not in r.stdout
