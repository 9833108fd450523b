"""The sharded training step across real ranks: four CPU processes of a
`gloo` group on this machine (a file store, local sockets), a 2x2 ("data", "model")
mesh, against the unsharded port on the same weights and batch. The
one-rank tests (tests/test_torch_sharding.py) show equal bits; these show
that the local regions' gradients, declared partial where each rank's
part adds to them, sum to the unsharded step's when the rows, heads,
d_ff, the experts' f and the vocabulary are really split (and, for
RecurrentGemma's `rows_region`, the rows alone).
"""
import json
import os
import pathlib
import subprocess
import sys
import textwrap

import pytest

ROOT = pathlib.Path(__file__).resolve().parent.parent

MULTI_CASES = [("phi4-mini-3.8b", 2), ("qwen2-moe-a2.7b", 1),
               ("gemma3-4b", 1), ("recurrentgemma-9b", 1)]

_MULTI_RANK = textwrap.dedent("""
    import dataclasses, json, sys
    import torch, torch.distributed as dist
    import torch.multiprocessing as mp

    def run(rank, store, cases, out):
        dist.init_process_group("gloo", init_method=f"file://{store}",
                                rank=rank, world_size=4)
        from repro_torch.configs import get_config
        from repro_torch.launch.mesh import make_mesh
        from repro_torch.models import get_model
        from repro_torch.models.common import set_activation_mesh, tree_leaves
        from repro_torch.parallel import batch_spec, distribute, make_rules
        from repro_torch.train.optim import OptimizerConfig, make_optimizer
        from repro_torch.train.trainer import (make_train_step,
                                               train_state_shardings)
        mesh = make_mesh((2, 2), ("data", "model"), "cpu")
        rules = make_rules(mesh)
        res = {}
        for arch, mb in cases:
            cfg = dataclasses.replace(get_config(arch, smoke=True),
                                      param_dtype=torch.float32)
            model = get_model(cfg)
            opt = make_optimizer(OptimizerConfig(name="sgd", lr=1.0))
            params = model.init(torch.Generator().manual_seed(0))
            toks = torch.randint(0, cfg.vocab_size, (8, 16),
                                 generator=torch.Generator().manual_seed(1))
            batch = {"tokens": toks, "labels": toks}
            l0, p0, _ = make_train_step(model, opt, microbatches=mb)(
                params, opt.init(params), batch)
            ps, osd, _, _ = train_state_shardings(rules, model, opt)
            set_activation_mesh(mesh)
            l1, p1, _ = make_train_step(model, opt, microbatches=mb,
                                        grad_shardings=ps)(
                distribute(params, ps), distribute(opt.init(params), osd),
                distribute(batch, batch_spec(rules, batch)))
            set_activation_mesh(None)
            gaps = []
            for p, a, b in zip(tree_leaves(params), tree_leaves(p0),
                               tree_leaves(p1)):
                b = b.full_tensor()
                gaps.append(float((a - b).abs().max()
                                  / (a - p).abs().max().clamp_min(1e-30)))
            res[f"{arch}|{mb}"] = dict(loss=[float(l0), float(l1)],
                                       update_gap=max(gaps))
        if rank == 0:
            with open(out, "w") as f:
                json.dump(res, f)
        dist.destroy_process_group()

    if __name__ == "__main__":
        store, cases, out = sys.argv[1], json.loads(sys.argv[2]), sys.argv[3]
        mp.start_processes(run, args=(store, cases, out), nprocs=4,
                           start_method="spawn")
""")


@pytest.fixture(scope="module")
def multi_rank(tmp_path_factory):
    """The cases' plain and sharded steps on every rank of a 2x2
    ("data", "model") mesh of four gloo processes on this machine, which
    meet through a file store in the test's temporary directory."""
    tmp = tmp_path_factory.mktemp("multi_rank")
    script, out = tmp / "multi_rank.py", tmp / "out.json"
    script.write_text(_MULTI_RANK)
    env = dict(os.environ)
    env["PYTHONPATH"] = str(ROOT / "src")
    r = subprocess.run([sys.executable, str(script), str(tmp / "store"),
                        json.dumps(MULTI_CASES), str(out)],
                       capture_output=True, text=True, timeout=300, env=env,
                       cwd=ROOT)
    assert r.returncode == 0, r.stderr[-3000:]
    return json.loads(out.read_text())


@pytest.mark.parametrize("arch,mb", MULTI_CASES)
def test_sharded_step_across_four_ranks(multi_rank, arch, mb):
    """Rows split over "data", heads, d_ff, experts' f and the vocabulary
    over "model": the local regions' gradients, declared partial where
    each rank's part adds to them, sum to the unsharded step's. SGD at lr
    1, float32: the loss within rel 1e-6; each leaf's update within 1e-3
    of its largest entry (float32 sums in other orders, and the update
    read back as p_new - p), and with two microbatches within 2^-7 (the
    reference's bf16 cast of the mean gradient rounds on each side)."""
    r = multi_rank[f"{arch}|{mb}"]
    l0, l1 = r["loss"]
    assert abs(l1 - l0) <= 1e-6 * abs(l0)
    assert r["update_gap"] <= (1e-3 if mb == 1 else 2.0 ** -7)
