"""The port's step counter (`repro_torch.launch.hlo_analysis`) and roofline
(`launch.roofline`).

* Collectives: each `_c10d_functional` collective counts its result bytes
  under the reference's kind names; a loop of 7 all-reduces counts 7 (eager
  execution issues every trip: there is no trip multiplication to do).
* Around DTensor code the counter counts the local product, not the
  global one, and the all-gather DTensor issues for it.
* Bytes: inputs plus outputs of each op, views none; memory: the peak of
  live storages.
* Roofline: `count_params` and `model_flops` equal the reference's for all
  ten configs; the terms use the H100 figures.

The collectives need a process group: they run in a subprocess with a
`fake` group of 4 ranks (every collective a no-op with the right shapes).
"""
import json
import os
import pathlib
import subprocess
import sys
import textwrap

import jax
import pytest
import torch

from repro.configs import ARCH_IDS
from repro.configs import get_config as ref_config
from repro.launch import roofline as rroof
from repro.models.registry import get_model as ref_model
from repro_torch.configs import get_config
from repro_torch.launch import roofline
from repro_torch.launch.hlo_analysis import (StepCounter, analyze_collectives,
                                             cost_analysis_dict)
from repro_torch.models import get_model

ROOT = pathlib.Path(__file__).resolve().parent.parent

_COLLECTIVES = textwrap.dedent("""
    import json, torch
    import torch.distributed as dist
    import torch.distributed._functional_collectives as funcol
    from torch.distributed.tensor import Shard, Replicate, distribute_tensor
    from repro_torch.launch.hlo_analysis import StepCounter
    from repro_torch.launch.mesh import make_mesh, start_process_group
    start_process_group("fake", 4)
    group = dist.group.WORLD
    x = torch.ones(8, dtype=torch.float32)
    out = {}
    c = StepCounter()
    with c:
        funcol.all_gather_tensor(x, 0, group).wait()
        funcol.reduce_scatter_tensor(x, "sum", 0, group).wait()
        funcol.all_to_all_single(x, None, None, group).wait()
        funcol.all_reduce(x.to(torch.bfloat16), "sum", group).wait()
    out["kinds"] = [dict(c.coll_bytes), dict(c.coll_count)]
    c = StepCounter()
    with c:
        y = x
        for _ in range(7):
            y = funcol.all_reduce(y, "sum", group)
        y.wait()
    out["loop"] = [dict(c.coll_bytes), dict(c.coll_count)]

    mesh = make_mesh((2, 2), ("data", "model"), "cpu")
    a = distribute_tensor(torch.randn(16, 64), mesh, [Shard(0), Replicate()])
    w = distribute_tensor(torch.randn(64, 32), mesh, [Shard(0), Shard(1)])
    c = StepCounter()
    with c:
        (a @ w).full_tensor()
    out["dtensor"] = [c.flops, dict(c.coll_count), dict(c.coll_bytes)]
    print(json.dumps(out))
""")


@pytest.fixture(scope="module")
def collectives():
    env = dict(os.environ)
    env["PYTHONPATH"] = str(ROOT / "src")
    r = subprocess.run([sys.executable, "-c", _COLLECTIVES],
                       capture_output=True, text=True, timeout=120, env=env,
                       cwd=ROOT)
    assert r.returncode == 0, r.stderr[-3000:]
    return json.loads(r.stdout.strip().splitlines()[-1])


def test_collective_bytes_are_result_bytes_by_kind(collectives):
    by_bytes, by_count = collectives["kinds"]
    # 8 float32 items on 4 ranks: the gather's result holds 32, the
    # scatter's 2; all-to-all keeps 8; the bf16 all-reduce 8 of 2 bytes
    assert by_bytes == {"all-gather": 32 * 4, "reduce-scatter": 2 * 4,
                        "all-to-all": 8 * 4, "all-reduce": 8 * 2}
    assert by_count == {"all-gather": 1, "reduce-scatter": 1,
                        "all-to-all": 1, "all-reduce": 1}


def test_loop_of_seven_all_reduces_counts_seven(collectives):
    by_bytes, by_count = collectives["loop"]
    assert by_count == {"all-reduce": 7}
    assert by_bytes == {"all-reduce": 7 * 8 * 4}


def test_dtensor_product_counts_the_local_product(collectives):
    flops, counts, nbytes = collectives["dtensor"]
    # (16, 64) rows on "data" times (64, 32) gathered on "data", columns on
    # "model": each device multiplies (8, 64) by (64, 16)
    assert flops == 2 * 8 * 64 * 16
    assert counts.get("all-gather", 0) >= 1


def test_bytes_and_views():
    x = torch.ones(256, 256)
    c = StepCounter()
    with c:
        y = x.view(-1)            # a view: no bytes
        assert c.bytes_accessed == 0
        z = y + 1                 # reads 256 KiB, writes 256 KiB
    assert c.bytes_accessed == 2 * 256 * 256 * 4
    assert c.flops == 0
    assert analyze_collectives(c).total_count == 0
    assert cost_analysis_dict(c) == {"flops": 0.0,
                                     "bytes accessed": 2 * 256 * 256 * 4.0}
    del z


def test_matmul_flops_and_peak_memory():
    a, b = torch.ones(32, 64), torch.ones(64, 16)
    c = StepCounter()
    assert c.register([a, b]) == (32 * 64 + 64 * 16) * 4
    with c:
        t = a @ b                 # 2 KiB live
        u = (t * 2).sum()         # another 2 KiB at once
        del t
        v = torch.ones(8)
    assert c.flops == 2 * 32 * 64 * 16
    assert c.peak_bytes == c.argument_bytes + 2 * 32 * 16 * 4 + 4
    assert c.live_bytes < c.peak_bytes
    del u, v


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_count_params_and_model_flops_equal_reference(arch):
    rm = ref_model(ref_config(arch))
    tm = get_model(get_config(arch))
    cfg = tm.cfg
    want = rroof.count_params(rm.abstract(), rm.axes(), top_k=cfg.top_k,
                              num_experts=cfg.num_experts)
    got = roofline.count_params(tm.abstract(), tm.axes(), top_k=cfg.top_k,
                                num_experts=cfg.num_experts)
    assert got == pytest.approx(want, rel=1e-12)
    for kind in ("train", "prefill", "decode"):
        assert roofline.model_flops(kind, got[1], 4096) == \
            rroof.model_flops(kind, want[1], 4096)


def test_roofline_terms_use_the_h100_figures():
    rt = roofline.terms_from_analysis(989e12, 3.35e12, 450e9, 4, 989e12)
    assert rt.compute_s == rt.memory_s == rt.collective_s == 1.0
    assert rt.useful_ratio == 0.25 and rt.roofline_fraction == 1.0
    assert (roofline.PEAK_FLOPS, roofline.HBM_BW, roofline.NVLINK_BW,
            roofline.F32_PEAK_FLOPS) == (989e12, 3.35e12, 450e9, 67e12)
    rt = roofline.terms_from_analysis(1.0, 1e15, 0.0, 1, 0.0)
    assert rt.dominant == "memory"
