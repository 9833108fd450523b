"""Production-mesh dry-run: one step of every (arch x shape x mesh) cell
on fake devices, with its per-device cost and roofline terms. The fake
tensors are on the card's device type, so the command needs a card
(`run_cell(..., device_type="cpu")` runs a cell on the CPU):

    python -m repro_torch.launch.dryrun --arch gemma3-4b --shape train_4k --mesh multi
    python -m repro_torch.launch.dryrun --all --out results/dryrun_torch.jsonl
    python -m repro_torch.launch.report results/dryrun_torch.jsonl

The port of `repro.launch.dryrun`. The reference lowers and compiles each
cell for 256 or 512 forced XLA host devices. Here `run_cell` starts a
`fake` process group of that size (this process is rank 0, every
collective a no-op), builds the production mesh on it, places parameters,
optimizer state, batch and caches as DTensors of fake tensors by the
sharding rules, and runs the cell's step (train, prefill or decode)
eagerly under `launch.hlo_analysis.StepCounter`, which counts one
device's operations, bytes, collectives and live memory. The step's own
small tensors (positions, masks) are real. A cell that raises is recorded
with `ok: false`.

One JSON record a cell, with the reference's fields: `memory` (the peak of
live local bytes over the step: arguments, outputs, the rest as temp; no
buffer is donated), `cost` (per device), `collectives` (result bytes by
kind), `roofline` (H100 figures, `launch.roofline`), `probes`, `lower_s`
(placing the state) and `compile_s` (the step's seconds). The probes are
the reference's (a layer's forward and backward, the optimizer update)
and are recorded only: eager execution runs every layer and every
microbatch, so the step's count is direct.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import math
import pathlib
import time
import traceback
from typing import Callable

import torch

from ..configs import ARCH_IDS, SHAPES, cells, get_config
from ..core import resolve_device
from ..models.common import (abstract_params, axes_tree, set_activation_mesh,
                             tree_zip_map)
from ..models.registry import get_model
from ..parallel.sharding import (NamedSharding, PartitionSpec, batch_spec,
                                 kv_cache_sharding, make_rules,
                                 mesh_axis_size, params_sharding)
from ..train.optim import OptimizerConfig, make_optimizer
from ..train.trainer import (make_train_step, opt_state_sharding,
                             train_state_shardings)
from .hlo_analysis import StepCounter, analyze_collectives, cost_analysis_dict
from .mesh import (PRODUCTION_SHAPES, make_mesh, start_process_group,
                   stop_process_group)
from .roofline import count_params, model_flops, terms_from_analysis

# optimizer-state memory is the binding constraint at 1T params
OPTIMIZER_OVERRIDES = {
    "kimi-k2-1t-a32b": OptimizerConfig(name="adafactor"),
    "qwen2-vl-72b": OptimizerConfig(name="adamw", moment_dtype=torch.bfloat16),
}
DEFAULT_OPT = OptimizerConfig(name="adamw")

# grad-accumulation microbatches per train cell
MICROBATCH_OVERRIDES = {
    "default": 4,
    "xlstm-125m": 1,
    "qwen2-moe-a2.7b": 4,
    "gemma3-4b": 4,
    "whisper-large-v3": 4,
    "phi4-mini-3.8b": 8,
    "chatglm3-6b": 8,
    "recurrentgemma-9b": 8,
    "mistral-nemo-12b": 8,
    "qwen2-vl-72b": 16,
    "kimi-k2-1t-a32b": 16,
}
# the 1T cell can't afford an f32 grad accumulator
ACCUM_DTYPE_OVERRIDES = {"kimi-k2-1t-a32b": torch.bfloat16}


def _opt_for(arch: str):
    return make_optimizer(OPTIMIZER_OVERRIDES.get(arch, DEFAULT_OPT))


def _dp_axes(mesh):
    return tuple(a for a in ("pod", "data") if a in mesh.mesh_dim_names)


@dataclasses.dataclass
class Cell:
    """One cell's step, ready to run: `run(*args)` is counted; each probe
    is (fn, args, multiplier)."""
    run: Callable
    args: tuple
    meta: dict
    probes: dict


def place(fake_mode, tree, shardings, device_type: str):
    """Fake tensors of `tree`'s shapes and dtypes on `device_type`, placed
    as DTensors by `shardings` (a tree of NamedShardings)."""
    from torch.distributed.tensor import distribute_tensor

    def one(t, s):
        local = torch.empty(tuple(t.shape), dtype=t.dtype, device=device_type)
        return distribute_tensor(local, s.mesh, s.placements)
    with fake_mode:
        return tree_zip_map(one, tree, shardings)


def _redistribute(tree, shardings):
    """tree's tensors in `shardings`' placements; a plain tensor (a fresh
    decode state every rank makes alike) counts as replicated."""
    from torch.distributed.tensor import DTensor, Replicate

    def one(t, s):
        if not isinstance(t, DTensor):
            t = DTensor.from_local(t, s.mesh, [Replicate()] * s.mesh.ndim,
                                   run_check=False)
        return t.redistribute(s.mesh, s.placements)
    return tree_zip_map(one, tree, shardings)


def _opt_probe(opt, ap, ps, fake_mode, device_type):
    """The optimizer update alone, on bf16 gradients."""
    grads = place(fake_mode, tree_zip_map(
        lambda p: torch.empty(tuple(p.shape), dtype=torch.bfloat16,
                              device="meta"), ap), ps, device_type)
    return lambda g, s, p: opt.update(g, s, p), grads


def lower_cell(arch: str, shape_id: str, mesh, fake_mode, *,
               moe_ep: bool = False, microbatches: int | None = None,
               device_type: str = "cuda") -> Cell:
    """Place one cell's state on `mesh` and return its step."""
    from ..models import transformer as tfm
    cfg = get_config(arch)
    model = get_model(cfg)
    rules = make_rules(mesh, moe_ep=moe_ep)
    shape = SHAPES[shape_id]
    kind = shape["kind"]
    B, S = shape["global_batch"], shape["seq_len"]
    dp = _dp_axes(mesh)
    if microbatches is None:
        microbatches = MICROBATCH_OVERRIDES.get(
            arch, MICROBATCH_OVERRIDES["default"])
        # keep every DP shard busy: at least one row per shard per microbatch
        microbatches = max(1, min(microbatches, B // mesh_axis_size(mesh, dp)))

    def put(tree, shardings):
        return place(fake_mode, tree, shardings, device_type)

    probes = {}
    accum_dtype = ACCUM_DTYPE_OVERRIDES.get(arch, torch.float32)
    scan_layers = cfg.num_experts > 0 or (
        cfg.family in ("dense", "vlm", "moe") and cfg.num_layers >= 48)
    if kind == "train":
        opt = _opt_for(arch)
        if scan_layers:
            # MoE giants and >= 48 homogeneous layers train in the stacked
            # layout, as in the reference
            defs = tfm.stacked_param_defs(cfg)
            ap = abstract_params(defs, cfg.param_dtype)
            ax = axes_tree(defs)
            ps = params_sharding(rules, ap, ax)
            osd = opt_state_sharding(rules, opt, ap, ax)
            aos = opt.init(ap)
            loss_override = lambda p, b: tfm.loss_fn_scanned(cfg, p, b)
            # the reference's per-layer forward and backward probe, at the
            # microbatch's size
            Bm = B // microbatches
            ldefs = tfm.layer_defs(cfg, cfg.first_k_dense)
            lap = abstract_params(ldefs, cfg.param_dtype)
            lps = params_sharding(rules, lap, axes_tree(ldefs))
            dp_b = rules._fit(Bm, dp)
            x = torch.empty((Bm, S, cfg.d_model), dtype=cfg.param_dtype,
                            device="meta")
            # positions stay plain, as the model's own are (every rank
            # computes them alike)
            with fake_mode:
                pos = torch.empty((3, Bm, S) if cfg.mrope_sections
                                  else (Bm, S), dtype=torch.int32,
                                  device=device_type)
            n_tail = cfg.num_layers - cfg.first_k_dense
            probes["layer"] = (
                tfm.layer_fwdbwd_probe(cfg, cfg.first_k_dense),
                (put(lap, lps),
                 put(x, NamedSharding(mesh, PartitionSpec(dp_b, None, None))),
                 pos),
                microbatches * (n_tail - 1))
        else:
            ps, osd, ap, aos = train_state_shardings(rules, model, opt)
            loss_override = None
        if microbatches > 1:
            fn, grads = _opt_probe(opt, ap, ps, fake_mode, device_type)
            probes["opt"] = (fn, (grads, put(aos, osd), put(ap, ps)),
                             -(microbatches - 1))
        step = make_train_step(model, opt, microbatches=microbatches,
                               accum_dtype=accum_dtype, grad_shardings=ps,
                               loss_override=loss_override)
        batch = model.train_inputs(B, S)
        args = (put(ap, ps), put(aos, osd), put(batch, batch_spec(rules,
                                                                  batch)))
        run = step
    elif kind == "prefill":
        ap = model.abstract()
        ps = params_sharding(rules, ap, model.axes())
        batch = model.prefill_inputs(B, S)
        logits_sh = NamedSharding(mesh, PartitionSpec(rules._fit(B, dp),
                                                      None))

        def run(p, b):
            logits, caches = model.prefill(p, b)
            return (logits.redistribute(mesh, logits_sh.placements),
                    _redistribute(caches, kv_cache_sharding(rules, caches)))
        args = (put(ap, ps), put(batch, batch_spec(rules, batch)))
    elif kind == "decode":
        ap = model.abstract()
        ps = params_sharding(rules, ap, model.axes())
        caches = model.abstract_caches(B, S)
        cache_sh = kv_cache_sharding(rules, caches)
        tok = torch.empty((B,), dtype=torch.int32, device="meta")
        tok_sh = NamedSharding(mesh, PartitionSpec(rules._fit(B, dp)))
        logits_sh = NamedSharding(mesh, PartitionSpec(rules._fit(B, dp),
                                                      None))

        def run(p, t, c):
            logits, new = model.decode_step(p, t, c, S - 1)
            return (logits.redistribute(mesh, logits_sh.placements),
                    _redistribute(new, cache_sh))
        args = (put(ap, ps), put(tok, tok_sh), put(caches, cache_sh))
    else:
        raise ValueError(kind)

    # model-level FLOP accounting for the useful-compute ratio
    total, active, embed = count_params(model.abstract(), model.axes(),
                                        top_k=cfg.top_k,
                                        num_experts=cfg.num_experts)
    tokens = B * S if kind in ("train", "prefill") else B
    mf = model_flops(kind, active, tokens)
    prog_mult = microbatches if kind == "train" else 1
    meta = dict(arch=arch, shape=shape_id, kind=kind, global_batch=B,
                seq_len=S, params_total=total, params_active=active,
                params_embed=embed, model_flops=mf,
                microbatches=microbatches, program_multiplier=prog_mult)
    return Cell(run, args, meta, probes)


def measure(cell: Cell, fake_mode) -> dict:
    """Run the cell's step and its probes under a StepCounter each: the
    step's record fields (memory, cost, collectives, probes, compile_s)."""
    counter = StepCounter(fake_mode)
    counter.register(cell.args)
    t0 = time.perf_counter()
    with counter:
        out = cell.run(*cell.args)
    step_s = time.perf_counter() - t0
    out_bytes = counter.new_bytes(out)
    del out
    probes = {}
    for name, (fn, args, mult) in cell.probes.items():
        pc = StepCounter(fake_mode)
        with pc:
            fn(*args)
        ca = cost_analysis_dict(pc)
        probes[name] = dict(multiplier=mult, flops=ca["flops"],
                            bytes=ca["bytes accessed"])
    ca = cost_analysis_dict(counter)
    cs = analyze_collectives(counter)
    gib = 2.0 ** 30
    return dict(
        compile_s=round(step_s, 1),
        memory=dict(argument_gib=counter.argument_bytes / gib,
                    output_gib=out_bytes / gib,
                    temp_gib=max(0, counter.peak_bytes
                                 - counter.argument_bytes - out_bytes) / gib,
                    alias_gib=0.0,
                    peak_gib=counter.peak_bytes / gib),
        cost=dict(flops_per_device=ca["flops"],
                  bytes_per_device=ca["bytes accessed"],
                  program_flops=ca["flops"]),
        collectives=dict(bytes_by_kind=cs.bytes_by_kind,
                         count_by_kind=cs.count_by_kind,
                         total_bytes=cs.total_bytes,
                         total_count=cs.total_count),
        probes=probes)


def run_cell(arch: str, shape_id: str, *, multi_pod: bool, moe_ep=False,
             microbatches=None, device_type: str = "cuda"):
    """One cell on the fake production mesh: starts and stops the
    process's default group (a `fake` one of 256 or 512 ranks)."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    shape, axes = PRODUCTION_SHAPES[multi_pod]
    n_dev = math.prod(shape)
    start_process_group("fake", n_dev)
    try:
        mesh = make_mesh(shape, axes, device_type)
        set_activation_mesh(mesh)
        rec = dict(mesh="multi" if multi_pod else "single", devices=n_dev,
                   moe_ep=moe_ep, device_type=device_type)
        fake_mode = FakeTensorMode(allow_non_fake_inputs=True)
        t0 = time.perf_counter()
        cell = lower_cell(arch, shape_id, mesh, fake_mode, moe_ep=moe_ep,
                          microbatches=microbatches, device_type=device_type)
        rec.update(cell.meta)
        rec["lower_s"] = round(time.perf_counter() - t0, 1)
        rec.update(measure(cell, fake_mode))
    finally:
        set_activation_mesh(None)
        stop_process_group()
    c = rec["cost"]
    rt = terms_from_analysis(c["flops_per_device"], c["bytes_per_device"],
                             rec["collectives"]["total_bytes"], n_dev,
                             rec["model_flops"])
    rec["roofline"] = rt.as_dict()
    rec["ok"] = True
    return rec


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=ARCH_IDS)
    ap.add_argument("--shape", choices=list(SHAPES))
    ap.add_argument("--mesh", choices=["single", "multi", "both"],
                    default="both")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--moe-ep", action="store_true",
                    help="expert-parallel MoE variant (perf experiment)")
    ap.add_argument("--microbatch", type=int, default=None,
                    help="override grad-accumulation microbatches")
    ap.add_argument("--out", default=None)
    ap.add_argument("--skip-existing", action="store_true")
    args = ap.parse_args()

    todo = []
    meshes = {"single": [False], "multi": [True],
              "both": [False, True]}[args.mesh]
    if args.all:
        for a, s in cells():
            for m in meshes:
                todo.append((a, s, m))
    else:
        if not (args.arch and args.shape):
            ap.error("--arch/--shape or --all")
        for m in meshes:
            todo.append((args.arch, args.shape, m))

    outpath = pathlib.Path(args.out) if args.out else None
    done = set()
    if outpath and outpath.exists() and args.skip_existing:
        for line in outpath.read_text().splitlines():
            try:
                r = json.loads(line)
                if r.get("ok"):
                    done.add((r["arch"], r["shape"], r["mesh"],
                              r.get("moe_ep", False)))
            except json.JSONDecodeError:
                pass

    device_type = resolve_device().type
    for arch, shape_id, multi in todo:
        key = (arch, shape_id, "multi" if multi else "single", args.moe_ep)
        if key in done:
            print(f"SKIP {key}")
            continue
        print(f"=== {arch} x {shape_id} x "
              f"{'multi' if multi else 'single'} ===", flush=True)
        try:
            rec = run_cell(arch, shape_id, multi_pod=multi,
                           moe_ep=args.moe_ep, microbatches=args.microbatch,
                           device_type=device_type)
            print(f"  ok step={rec['compile_s']}s "
                  f"peak={rec['memory']['peak_gib']:.2f}GiB "
                  f"flops/dev={rec['cost']['flops_per_device']:.3e} "
                  f"coll={rec['collectives']['total_bytes']:.3e}B "
                  f"dominant={rec['roofline']['dominant']}", flush=True)
        except Exception as e:
            rec = dict(arch=arch, shape=shape_id,
                       mesh="multi" if multi else "single",
                       moe_ep=args.moe_ep, ok=False, error=str(e),
                       traceback=traceback.format_exc()[-2000:])
            print(f"  FAIL {e}", flush=True)
        if outpath:
            outpath.parent.mkdir(parents=True, exist_ok=True)
            with outpath.open("a") as f:
                f.write(json.dumps(rec) + "\n")


if __name__ == "__main__":
    main()
