"""The port's examples run on the CPU (`--device cpu`) and their printed
faithfulness checks hold: each asserts its own identities (the device
replay against the host simulator, span and event dollars against the
meter, the fleet's bill reconciled three ways) and exits non-zero if one
fails. `trace_a_request_torch.py`'s `obs.json` validates against the
checked-in schema."""
import json
import os
import pathlib
import subprocess
import sys

import pytest

from repro_torch.obs import validate

ROOT = pathlib.Path(__file__).resolve().parent.parent


def _run(name, *args, timeout=300):
    env = dict(os.environ)
    env["PYTHONPATH"] = str(ROOT / "src")
    r = subprocess.run([sys.executable, str(ROOT / "examples" / name),
                        "--device", "cpu", *args], cwd=ROOT, env=env,
                       capture_output=True, text=True, timeout=timeout)
    assert r.returncode == 0, r.stdout + r.stderr
    return r.stdout


def test_quickstart_torch():
    out = _run("quickstart_torch.py")
    assert "exact offline dollar-optimum" in out
    assert out.count("(cpu)") == 1 and "cost_belady" in out


def test_trace_a_request_torch(tmp_path):
    out = _run("trace_a_request_torch.py", "--out", str(tmp_path))
    assert "--- billing faithfulness ---" in out
    assert "serve.request" in out and "cache.get" in out
    snap = json.loads((tmp_path / "obs.json").read_text())
    schema = json.loads((ROOT / "tests" / "schemas" / "obs.json").read_text())
    assert validate(snap, schema) == []
    assert (tmp_path / "trace.chrome.json").stat().st_size > 0
    assert "# TYPE" in (tmp_path / "metrics.prom").read_text()


def test_fleet_governance_torch():
    out = _run("fleet_governance_torch.py")
    assert "billing identity (bit-equal)" in out
    assert "unanimous fleet policy" in out
    assert "fleet-mode engine" in out and "edge2" in out


def test_train_100m_torch():
    out = _run("train_100m_torch.py", "--smoke", "--steps", "4")
    assert "on cpu" in out and "trained 4 steps" in out
    assert "[egress audit]" in out and "store meter" in out


@pytest.mark.parametrize("name", ["policy_audit_torch.py",
                                  "serve_with_egress_cache_torch.py"])
def test_earlier_examples_run_on_the_cpu(name):
    assert _run(name)
