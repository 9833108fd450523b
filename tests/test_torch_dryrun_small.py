"""The port's dry-run machinery on small fake meshes (subprocesses: a
process has one default process group).

* tests/test_dryrun_small.py's assertions on gemma3-4b's smoke config: a
  2x4 ("data", "model") mesh of a `fake` group, the rules,
  `train_state_shardings`, `make_train_step` with two microbatches and
  `grad_shardings`, an 8 x 32 batch, fake tensors placed as DTensors, the
  step counted by `StepCounter`: per-device FLOPs, collectives and temp
  bytes.
* The counter counts one device's work: on a 1x1 `gloo` mesh with real
  tensors its FLOPs equal `FlopCounterMode`'s on the unsharded step
  exactly; on the 2x4 mesh they are below 0.75 of that global count.
* `run_cell` on a production cell (qwen2-moe-a2.7b x decode_32k, the
  16x16 mesh of 256 fake ranks): the record has the reference's fields.
"""
import json
import os
import pathlib
import subprocess
import sys
import textwrap

import pytest

ROOT = pathlib.Path(__file__).resolve().parent.parent

_SCRIPT = textwrap.dedent("""
    import dataclasses, json, torch
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.utils.flop_counter import FlopCounterMode
    from repro_torch.configs import get_config
    from repro_torch.models import get_model
    from repro_torch.models.common import set_activation_mesh
    from repro_torch.parallel import make_rules, batch_spec, distribute
    from repro_torch.train.optim import OptimizerConfig, make_optimizer
    from repro_torch.train.trainer import make_train_step, train_state_shardings
    from repro_torch.launch.dryrun import place
    from repro_torch.launch.hlo_analysis import (StepCounter,
                                                 analyze_collectives,
                                                 cost_analysis_dict)
    from repro_torch.launch.mesh import (make_mesh, start_process_group,
                                         stop_process_group)

    cfg = get_config("gemma3-4b", smoke=True)
    model = get_model(cfg)
    opt = make_optimizer(OptimizerConfig())
    out = {}

    # the global count: FlopCounterMode on the unsharded step
    g = torch.Generator().manual_seed(0)
    params = model.init(g)
    toks = torch.randint(0, cfg.vocab_size, (8, 32), generator=g)
    batch = {"tokens": toks, "labels": toks}
    plain = make_train_step(model, opt, microbatches=2)
    with FlopCounterMode(display=False) as fc:
        plain(params, opt.init(params), batch)
    out["global_flops"] = fc.get_total_flops()

    # a 1x1 gloo mesh, real tensors
    start_process_group("gloo")
    mesh = make_mesh((1, 1), ("data", "model"), "cpu")
    set_activation_mesh(mesh)
    rules = make_rules(mesh)
    ps, osd, ap, aos = train_state_shardings(rules, model, opt)
    step = make_train_step(model, opt, microbatches=2, grad_shardings=ps)
    args = (distribute(params, ps), distribute(opt.init(params), osd),
            distribute(batch, batch_spec(rules, batch)))
    c = StepCounter()
    c.register(args)
    with c:
        step(*args)
    out["one_rank_flops"] = cost_analysis_dict(c)["flops"]
    set_activation_mesh(None)
    stop_process_group()

    # the reference's mini mesh: 2x4 fake ranks, fake tensors
    start_process_group("fake", 8)
    mesh = make_mesh((2, 4), ("data", "model"), "cpu")
    set_activation_mesh(mesh)
    rules = make_rules(mesh)
    ps, osd, ap, aos = train_state_shardings(rules, model, opt)
    step = make_train_step(model, opt, microbatches=2, grad_shardings=ps)
    b = model.train_inputs(8, 32)
    fm = FakeTensorMode(allow_non_fake_inputs=True)
    args = (place(fm, ap, ps, "cpu"), place(fm, aos, osd, "cpu"),
            place(fm, b, batch_spec(rules, b), "cpu"))
    c = StepCounter(fm)
    c.register(args)
    with c:
        step(*args)
    ca = cost_analysis_dict(c)
    cs = analyze_collectives(c)
    out.update(flops=ca["flops"], bytes=ca["bytes accessed"],
               coll_bytes=cs.total_bytes, coll_count=cs.total_count,
               kinds=sorted(cs.count_by_kind),
               temp_bytes=c.peak_bytes - c.argument_bytes,
               argument_bytes=c.argument_bytes)
    print(json.dumps(out))
""")


def _run(code, *args, timeout=300):
    env = dict(os.environ)
    env["PYTHONPATH"] = str(ROOT / "src")
    r = subprocess.run([sys.executable, "-c", code, *args],
                       capture_output=True, text=True, timeout=timeout,
                       env=env, cwd=ROOT)
    assert r.returncode == 0, r.stderr[-3000:]
    return json.loads(r.stdout.strip().splitlines()[-1])


@pytest.fixture(scope="module")
def mini():
    return _run(_SCRIPT)


def test_mini_mesh_dryrun(mini):
    assert mini["flops"] > 1e6            # real per-device work counted
    assert mini["coll_count"] > 0         # DTensor issued collectives
    assert mini["coll_bytes"] > 0
    assert mini["temp_bytes"] > 0
    assert mini["bytes"] > 0 and mini["argument_bytes"] > 0
    assert set(mini["kinds"]) <= {"all-gather", "all-reduce",
                                  "reduce-scatter", "all-to-all",
                                  "collective-permute"}


def test_one_rank_flops_equal_flop_counter_on_the_unsharded_step(mini):
    assert mini["global_flops"] > 0
    assert mini["one_rank_flops"] == mini["global_flops"]


def test_per_device_flops_below_the_global_count(mini):
    assert mini["flops"] < 0.75 * mini["global_flops"]


_CELL = textwrap.dedent("""
    import json
    from repro_torch.launch.dryrun import run_cell
    print(json.dumps(run_cell("qwen2-moe-a2.7b", "decode_32k",
                              multi_pod=False, device_type="cpu")))
""")


def test_run_cell_production_decode():
    rec = _run(_CELL, timeout=240)
    assert rec["ok"] and rec["devices"] == 256 and rec["mesh"] == "single"
    for key in ("memory", "cost", "collectives", "roofline", "probes",
                "lower_s", "compile_s", "model_flops", "params_total"):
        assert key in rec
    assert rec["params_total"] == 14_315_587_584
    assert rec["collectives"]["total_count"] > 0
    assert 0 < rec["cost"]["flops_per_device"]
    mem = rec["memory"]
    assert mem["peak_gib"] >= mem["argument_gib"] > 0
    rt = rec["roofline"]
    assert rt["dominant"] in ("compute", "memory", "collective")
    assert rt["compute_s"] == rec["cost"]["flops_per_device"] / 989e12
