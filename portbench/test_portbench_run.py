"""The run's entry: no card, no result; JAX loaded, no result; and on a
card (marked `cuda`), a short run of each cell is correct and reports its
metrics."""
import json
import subprocess
import sys

import pytest

from portbench import run, spec


@pytest.fixture
def card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU; torch sees none")


def test_no_card_no_result(tmp_path):
    import torch
    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    out = subprocess.run([sys.executable, str(spec.HERE / "run.py"),
                          "--workload", "memcache.panel96", "--seed", "1",
                          "--seconds", "1"], capture_output=True, text=True,
                         timeout=300, cwd=tmp_path)
    assert out.returncode != 0 and out.stdout.strip() == ""


def test_forbidden_modules():
    ok = ["repro_torch", "repro_torch.core", "numpy", "jaxtyping", "reprox"]
    assert run.forbidden_modules(ok) == []
    bad = ok + ["repro.core.trace", "jax.numpy", "jaxlib", "flax.linen"]
    assert run.forbidden_modules(bad) == ["flax", "jax", "jaxlib", "repro"]


def test_end_children_ends_and_waits():
    proc = subprocess.Popen([sys.executable, "-c", "import time; time.sleep(60)"])
    try:
        assert proc.pid in {pid for pid, _ in run.children()}
        assert proc.pid in {pid for pid, _ in run.end_children()}
        assert proc.pid not in {pid for pid, _ in run.children()}
    finally:
        proc.kill()
        proc.wait()


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["memcache.panel96", "cdn.panel96"])
@pytest.mark.parametrize("trace", [False, True])
def test_short_run_on_the_card(card, name, trace):
    cell = spec.load_cell(name)
    r = run.run_cell(cell, 2**31 + 99, 2.0, trace)
    assert r["correct"] and r["device"]["platform"] == "gpu"
    want = cell.per_layer if trace else cell.end_to_end
    assert set(r["metrics"]) == {m["name"] for m in want}
    json.dumps(r)
