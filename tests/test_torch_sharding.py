"""The port's sharding rules (`repro_torch.parallel`) against the JAX
package's, and the sharded training step on a one-rank CPU mesh.

* tests/test_sharding.py's six rule tests on the port's `ShardingRules`.
* Specs entry by entry against the reference's, computed in a JAX
  subprocess with 512 forced host devices (no compile): every parameter
  leaf of all ten configs, AdamW and Adafactor state, `batch_spec` of train
  and prefill inputs and `kv_cache_sharding` of `abstract_caches` at
  every SHAPES cell, on the single- and multi-pod meshes, with `moe_ep` on
  and off. The port's side reads only the mesh's axis names and sizes.
* Placements and local shard shapes on a `fake` 2x16x16 DeviceMesh.
* The sharded step: on a `gloo` world-1 1x1 mesh, `make_train_step` with
  DTensor parameters and `grad_shardings` against the unsharded port (a
  dense and a MoE smoke config, AdamW and Adafactor): loss and every new
  parameter and state leaf bit-equal; and against the reference's jitted
  step on its `make_host_mesh` with `set_activation_mesh` set (the MoE
  through `shard_map`), float32 at rtol = atol = 1e-4.

Every process group lives in a subprocess of its own (a process has one
default group), with a timeout.
"""
import json
import os
import pathlib
import subprocess
import sys
import textwrap

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCH_IDS, SHAPES
from repro_torch.configs import get_config
from repro_torch.models import get_model
from repro_torch.parallel import sharding as sh
from repro_torch.parallel.sharding import PartitionSpec as P
from repro_torch.train.optim import OptimizerConfig, make_optimizer
from repro_torch.train.trainer import opt_state_sharding

import _torch_parity as parity

ROOT = pathlib.Path(__file__).resolve().parent.parent
TOL = dict(rtol=1e-4, atol=1e-4)


def _run(code: str, timeout: int = 240, env_extra=None) -> str:
    env = dict(os.environ)
    env["PYTHONPATH"] = str(ROOT / "src")
    env.update(env_extra or {})
    r = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, timeout=timeout, env=env, cwd=ROOT)
    assert r.returncode == 0, r.stderr[-3000:]
    return r.stdout.strip().splitlines()[-1]


# ---------------------------------------------------------------------------
# tests/test_sharding.py on the port
# ---------------------------------------------------------------------------

class FakeMesh:
    """Duck-typed stand-in so rule logic is testable without 512 devices."""
    def __init__(self, shape_dict):
        self.shape = shape_dict
        self.axis_names = tuple(shape_dict)
        self.size = int(np.prod(list(shape_dict.values())))


def _rules(multi=True, moe_ep=False):
    mesh = FakeMesh({"pod": 2, "data": 16, "model": 16} if multi
                    else {"data": 16, "model": 16})
    return sh.ShardingRules(
        mesh,
        {"embed": tuple(a for a in ("pod", "data") if a in mesh.axis_names),
         "vocab": "model", "heads": "model", "kv_heads": "model",
         "mlp": "model",
         "expert": "model" if moe_ep else None},
        dp_axes=tuple(a for a in ("pod", "data") if a in mesh.axis_names))


def test_fsdp_tp_spec():
    r = _rules()
    spec = r.spec_for((7168, 2048), ("embed", "mlp"))
    assert spec == P(("pod", "data"), "model")


def test_divisibility_fallback_drops_leading_axis():
    r = _rules()
    # 16 rows on a 32-way ("pod","data") axis -> keep the 16-way "data"
    spec = r.spec_for((16, 128), ("embed", None))
    assert spec == P("data", None)


def test_indivisible_drops_to_none():
    r = _rules()
    # a bare 20-head axis on a 16-way model axis: replicate
    spec = r.spec_for((1280, 20), ("embed", "kv_heads"))
    assert spec[1] is None
    # but the packed G*hd projection dim (20*64=1280) is divisible and shards
    spec2 = r.spec_for((1280, 20 * 64), ("embed", "kv_heads"))
    assert spec2[1] == "model"


def test_axis_used_once():
    r = _rules(multi=False)
    # two dims both wanting "model": second gets None
    spec = r.spec_for((2048, 2048), ("heads", "mlp"))
    assert spec == P("model", None)


def test_moe_ep_rules():
    r = _rules(moe_ep=True)
    spec = r.spec_for((384, 7168, 2048), ("expert", "embed", "mlp"))
    assert spec[0] == "model"       # experts over TP axis
    assert spec[2] is None          # mlp can't reuse "model"


def test_odd_dims_never_crash():
    r = _rules()
    for dims in [(1,), (3, 5), (17, 33, 7)]:
        spec = r.spec_for(dims, tuple(["embed", "heads", "mlp"][:len(dims)]))
        assert len(spec) == len(dims)


# ---------------------------------------------------------------------------
# every spec against the reference's
# ---------------------------------------------------------------------------

_JAX_SPECS = textwrap.dedent("""
    import json
    import jax
    from jax.sharding import NamedSharding
    from repro.configs import ARCH_IDS, SHAPES, get_config
    from repro.launch.mesh import make_production_mesh
    from repro.models.registry import get_model
    from repro.parallel.sharding import (batch_spec, kv_cache_sharding,
                                         make_rules, params_sharding)
    from repro.train.optim import OptimizerConfig, make_optimizer
    from repro.train.trainer import opt_state_sharding

    def flat(tree):
        leaves = jax.tree_util.tree_flatten_with_path(
            tree, is_leaf=lambda x: isinstance(x, NamedSharding))[0]
        out = {}
        for path, s in leaves:
            key = "/".join(str(getattr(k, "key", getattr(k, "idx", k)))
                           for k in path)
            out[key] = [list(e) if isinstance(e, tuple) else e
                        for e in tuple(s.spec)]
        return out

    res = {}
    for multi in (False, True):
        mesh = make_production_mesh(multi_pod=multi)
        for ep in (False, True):
            rules = make_rules(mesh, moe_ep=ep)
            for arch in ARCH_IDS:
                m = get_model(get_config(arch))
                ap, ax = m.abstract(), m.axes()
                key = f"{arch}|{multi}|{ep}"
                res[key + "|params"] = flat(params_sharding(rules, ap, ax))
                for opt in ("adamw", "adafactor"):
                    o = make_optimizer(OptimizerConfig(name=opt))
                    res[key + "|" + opt] = flat(
                        opt_state_sharding(rules, o, ap, ax))
                for shape, c in SHAPES.items():
                    B, S = c["global_batch"], c["seq_len"]
                    k2 = key + "|" + shape
                    res[k2 + "|train"] = flat(batch_spec(
                        rules, m.train_inputs(B, S)))
                    res[k2 + "|prefill"] = flat(batch_spec(
                        rules, m.prefill_inputs(B, S)))
                    res[k2 + "|caches"] = flat(kv_cache_sharding(
                        rules, m.abstract_caches(B, S)))
    print(json.dumps(res))
""")


@pytest.fixture(scope="module")
def jax_specs():
    env = {"XLA_FLAGS": "--xla_force_host_platform_device_count=512",
           "JAX_PLATFORMS": "cpu"}
    return json.loads(_run(_JAX_SPECS, env_extra=env))


def _flat(tree) -> dict:
    """{key path: spec as JSON} of a NamedSharding tree, keyed as JAX's
    paths are."""
    out = {}

    def walk(t, path):
        if isinstance(t, dict):
            for k, v in t.items():
                walk(v, path + (str(k),))
        elif isinstance(t, (list, tuple)):
            for i, v in enumerate(t):
                walk(v, path + (str(i),))
        else:
            out["/".join(path)] = [list(e) if isinstance(e, tuple) else e
                                   for e in t.spec]
    walk(tree, ())
    return out


def _port_specs(arch, multi, ep) -> dict:
    mesh = FakeMesh({"pod": 2, "data": 16, "model": 16} if multi
                    else {"data": 16, "model": 16})
    rules = sh.make_rules(mesh, moe_ep=ep)
    m = get_model(get_config(arch))
    ap, ax = m.abstract(), m.axes()
    key = f"{arch}|{multi}|{ep}"
    res = {key + "|params": _flat(sh.params_sharding(rules, ap, ax))}
    for opt in ("adamw", "adafactor"):
        o = make_optimizer(OptimizerConfig(name=opt))
        res[key + "|" + opt] = _flat(opt_state_sharding(rules, o, ap, ax))
    for shape, c in SHAPES.items():
        B, S = c["global_batch"], c["seq_len"]
        k2 = key + "|" + shape
        res[k2 + "|train"] = _flat(sh.batch_spec(rules,
                                                 m.train_inputs(B, S)))
        res[k2 + "|prefill"] = _flat(sh.batch_spec(rules,
                                                   m.prefill_inputs(B, S)))
        res[k2 + "|caches"] = _flat(sh.kv_cache_sharding(
            rules, m.abstract_caches(B, S)))
    return res


@pytest.mark.parametrize("ep", [False, True], ids=["baseline", "moe_ep"])
@pytest.mark.parametrize("multi", [False, True], ids=["single", "multi"])
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_specs_equal_reference(jax_specs, arch, multi, ep):
    got = _port_specs(arch, multi, ep)
    assert got.keys() <= jax_specs.keys()
    for key, specs in got.items():
        want = jax_specs[key]
        assert specs.keys() == want.keys(), key
        assert specs == want, key
    # the trees are not empty and some leaf is sharded
    assert any(e is not None for s in got[f"{arch}|{multi}|{ep}|params"]
               .values() for e in s)


def test_placements_follow_the_mesh_order():
    """Spec -> DTensor placements on a mesh (duck-typed: names and sizes)."""
    from torch.distributed.tensor import Replicate, Shard
    mesh = FakeMesh({"pod": 2, "data": 16, "model": 16})
    assert sh.placements(mesh, P(("pod", "data"), None, "model")) == \
        (Shard(0), Shard(0), Shard(2))
    assert sh.placements(mesh, P("data", None)) == \
        (Replicate(), Shard(0), Replicate())
    assert sh.placements(mesh, P()) == (Replicate(),) * 3
    with pytest.raises(ValueError, match="order"):
        sh.placements(mesh, P(("data", "pod")))


_LOCAL_SHARDS = textwrap.dedent("""
    import json, math, torch
    from torch._subclasses.fake_tensor import FakeTensorMode
    from repro_torch.configs import get_config
    from repro_torch.launch.mesh import make_production_mesh, start_process_group
    from repro_torch.launch.dryrun import place
    from repro_torch.models import get_model
    from repro_torch.parallel import make_rules, params_sharding
    from repro_torch.parallel.sharding import axis_sizes
    start_process_group("fake", 512)
    mesh = make_production_mesh(multi_pod=True, device_type="cpu")
    sizes = axis_sizes(mesh)
    out = []
    for arch, ep in (("kimi-k2-1t-a32b", False), ("qwen2-moe-a2.7b", True),
                     ("phi4-mini-3.8b", False)):
        m = get_model(get_config(arch))
        rules = make_rules(mesh, moe_ep=ep)
        ap = m.abstract()
        ps = params_sharding(rules, ap, m.axes())
        fm = FakeTensorMode()
        dt = place(fm, ap, ps, "cpu")
        leaves = []
        def walk(a, s, t):
            if isinstance(a, dict):
                for k in a: walk(a[k], s[k], t[k])
            elif isinstance(a, list):
                for x, y, z in zip(a, s, t): walk(x, y, z)
            else:
                want = []
                for d, e in zip(a.shape, s.spec):
                    axes = () if e is None else ((e,) if isinstance(e, str)
                                                 else e)
                    want.append(d // math.prod(sizes[x] for x in axes))
                leaves.append([list(t.to_local().shape), want,
                               list(t.shape), list(a.shape)])
        walk(ap, ps, dt)
        out.append([arch, leaves])
    print(json.dumps(out))
""")


def test_local_shards_on_the_multi_pod_mesh():
    """On a fake 2x16x16 DeviceMesh every placed leaf's local shard is its
    shape divided by its spec's axes, dim by dim (every rule's tuple is in
    the mesh's order, so DTensor splits as the spec says)."""
    out = json.loads(_run(_LOCAL_SHARDS))
    assert len(out) == 3
    for arch, leaves in out:
        assert leaves
        for local, want, glob, shape in leaves:
            assert glob == shape
            assert local == want, arch
        assert any(l != g for l, _, g, _ in leaves), arch


# ---------------------------------------------------------------------------
# the sharded step on a one-rank CPU mesh
# ---------------------------------------------------------------------------

STEP_CASES = [(a, o) for a in ("phi4-mini-3.8b", "qwen2-moe-a2.7b")
              for o in ("adamw", "adafactor")]
STEP_B, STEP_S, STEP_MB = 4, 16, 2

_SHARDED_STEP = textwrap.dedent("""
    import json, sys, dataclasses
    import torch
    from repro_torch.configs import get_config
    from repro_torch.launch.mesh import make_mesh, start_process_group
    from repro_torch.models import get_model
    from repro_torch.models.common import (set_activation_mesh, tree_leaves,
                                           tree_zip_map)
    from repro_torch.parallel import batch_spec, distribute, make_rules
    from repro_torch.train.optim import OptimizerConfig, make_optimizer
    from repro_torch.train.trainer import make_train_step, train_state_shardings
    tmp, cases, mb = sys.argv[1], json.loads(sys.argv[2]), int(sys.argv[3])
    start_process_group("gloo")
    mesh = make_mesh((1, 1), ("data", "model"), "cpu")
    rules = make_rules(mesh)
    res = {}
    for arch, opt_name in cases:
        cfg = dataclasses.replace(get_config(arch, smoke=True),
                                  param_dtype=torch.float32)
        model = get_model(cfg)
        params, toks = torch.load(f"{tmp}/{arch}.pt", weights_only=True)
        batch = {"tokens": toks, "labels": toks}
        opt = make_optimizer(OptimizerConfig(name=opt_name))
        ps, osd, _, _ = train_state_shardings(rules, model, opt)
        state = opt.init(params)
        l0, p0, s0 = make_train_step(model, opt, microbatches=mb)(
            params, state, batch)
        set_activation_mesh(mesh)
        step = make_train_step(model, opt, microbatches=mb,
                               grad_shardings=ps)
        l1, p1, s1 = step(distribute(params, ps), distribute(state, osd),
                          distribute(batch, batch_spec(rules, batch)))
        set_activation_mesh(None)
        sharded = tree_leaves([p1, s1])
        full = [t.full_tensor() for t in sharded]
        torch.save([t.full_tensor() for t in tree_leaves(p1)],
                   f"{tmp}/{arch}_{opt_name}_out.pt")
        kept = []
        tree_zip_map(lambda t, s: kept.append(t.placements == s.placements),
                     p1, ps)
        res[f"{arch}|{opt_name}"] = dict(
            loss_plain=float(l0), loss_sharded=float(l1),
            leaves=len(full),
            bit_equal=float(l0) == float(l1) and all(
                torch.equal(a, b) for a, b in
                zip(tree_leaves([p0, s0]), full)),
            dtensor=all(type(t).__name__ == "DTensor" for t in sharded),
            placements_kept=all(kept))
    print(json.dumps(res))
""")


def _token_batch(cfg, seed=3):
    rng = np.random.default_rng(seed)
    return rng.integers(0, cfg.vocab_size, (STEP_B, STEP_S)).astype(np.int64)


@pytest.fixture(scope="module")
def sharded_steps(tmp_path_factory):
    """The port's sharded and unsharded steps (in a subprocess) on the
    reference's float32 weights, and the reference's jitted host-mesh
    steps on the same weights and batch."""
    from jax.sharding import NamedSharding, PartitionSpec as JP
    from repro.launch.mesh import make_host_mesh
    from repro.models import common as rcommon
    from repro.parallel.sharding import batch_spec as rbatch_spec
    from repro.parallel.sharding import make_rules as rmake_rules
    from repro.train import optim as roptim
    from repro.train.trainer import make_train_step as rmake_train_step
    from repro.train.trainer import train_state_shardings as rtss

    tmp = tmp_path_factory.mktemp("sharded_step")
    ref = {}
    for arch in ("phi4-mini-3.8b", "qwen2-moe-a2.7b"):
        rm, rp, _, tp = parity.models(arch, "float32")
        toks = _token_batch(rm.cfg)
        torch.save([tp, torch.from_numpy(toks)], tmp / f"{arch}.pt")
        mesh = make_host_mesh()
        rcommon.set_activation_mesh(mesh)
        try:
            for opt_name in ("adamw", "adafactor"):
                opt = roptim.make_optimizer(roptim.OptimizerConfig(
                    name=opt_name))
                rules = rmake_rules(mesh)
                ps, osd, _, _ = rtss(rules, rm, opt)
                jt = jnp.asarray(toks.astype(np.int32))
                batch = {"tokens": jt, "labels": jt}
                step = rmake_train_step(rm, opt, microbatches=STEP_MB,
                                        grad_shardings=ps)
                with mesh:
                    fn = jax.jit(step, in_shardings=(
                        ps, osd, rbatch_spec(rules, batch)),
                        out_shardings=(NamedSharding(mesh, JP()), ps, osd))
                    loss, newp, _ = fn(rp, opt.init(rp), batch)
                ref[f"{arch}|{opt_name}"] = (
                    float(loss), [np.asarray(x, np.float32)
                                  for x in jax.tree.leaves(newp)])
        finally:
            rcommon.set_activation_mesh(None)
    env = dict(os.environ)
    env["PYTHONPATH"] = str(ROOT / "src")
    r = subprocess.run([sys.executable, "-c", _SHARDED_STEP, str(tmp),
                        json.dumps(STEP_CASES), str(STEP_MB)],
                       capture_output=True, text=True, timeout=300, env=env,
                       cwd=ROOT)
    assert r.returncode == 0, r.stderr[-3000:]
    return tmp, json.loads(r.stdout.strip().splitlines()[-1]), ref


@pytest.mark.parametrize("arch,opt", STEP_CASES)
def test_sharded_step_bit_equal_to_unsharded(sharded_steps, arch, opt):
    _, out, _ = sharded_steps
    r = out[f"{arch}|{opt}"]
    assert r["dtensor"] and r["placements_kept"]
    assert r["bit_equal"], r
    assert np.isfinite(r["loss_plain"])


@pytest.mark.parametrize("arch,opt", STEP_CASES)
def test_sharded_step_matches_reference_host_mesh(sharded_steps, arch, opt):
    tmp, out, ref = sharded_steps
    r = out[f"{arch}|{opt}"]
    want_loss, want = ref[f"{arch}|{opt}"]
    assert abs(r["loss_sharded"] - want_loss) <= 1e-4 * abs(want_loss)
    got = [t.numpy() for t in torch.load(tmp / f"{arch}_{opt}_out.pt",
                                          weights_only=True)]
    # the port's tree keeps the reference's keys, so leaves come in the
    # reference's order
    assert len(got) == len(want)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, **TOL)



FAMILIES = ["qwen2-vl-72b", "whisper-large-v3", "recurrentgemma-9b",
            "xlstm-125m"]

_FAMILY_STEPS = textwrap.dedent("""
    import json, sys
    import torch
    from repro_torch.configs import get_config
    from repro_torch.launch.mesh import make_mesh, start_process_group
    from repro_torch.models import get_model
    from repro_torch.models.common import set_activation_mesh, tree_leaves
    from repro_torch.parallel import batch_spec, distribute, make_rules
    from repro_torch.train.optim import OptimizerConfig, make_optimizer
    from repro_torch.train.trainer import make_train_step, train_state_shardings
    start_process_group("gloo")
    mesh = make_mesh((1, 1), ("data", "model"), "cpu")
    rules = make_rules(mesh)
    res = {}
    for arch in json.loads(sys.argv[1]):
        model = get_model(get_config(arch, smoke=True))
        cfg = model.cfg
        g = torch.Generator().manual_seed(4)
        params = model.init(g)
        toks = torch.randint(0, cfg.vocab_size, (4, 16), generator=g)
        batch = {"tokens": toks, "labels": toks}
        extra = model.train_inputs(4, 16)
        for k in ("frames", "vision_embeds"):
            if k in extra:
                batch[k] = torch.randn(tuple(extra[k].shape),
                                       generator=g).to(extra[k].dtype)
        opt = make_optimizer(OptimizerConfig(name="adamw"))
        ps, osd, _, _ = train_state_shardings(rules, model, opt)
        l0, p0, s0 = make_train_step(model, opt, microbatches=2)(
            params, opt.init(params), batch)
        set_activation_mesh(mesh)
        l1, p1, s1 = make_train_step(model, opt, microbatches=2,
                                     grad_shardings=ps)(
            distribute(params, ps), distribute(opt.init(params), osd),
            distribute(batch, batch_spec(rules, batch)))
        set_activation_mesh(None)
        res[arch] = float(l0) == float(l1) and all(
            torch.equal(a, b.full_tensor()) for a, b in
            zip(tree_leaves([p0, s0]), tree_leaves([p1, s1])))
    print(json.dumps(res))
""")


@pytest.fixture(scope="module")
def family_steps():
    env = dict(os.environ)
    env["PYTHONPATH"] = str(ROOT / "src")
    r = subprocess.run([sys.executable, "-c", _FAMILY_STEPS,
                        json.dumps(FAMILIES)], capture_output=True,
                       text=True, timeout=300, env=env, cwd=ROOT)
    assert r.returncode == 0, r.stderr[-3000:]
    return json.loads(r.stdout.strip().splitlines()[-1])


@pytest.mark.parametrize("arch", FAMILIES)
def test_every_family_sharded_step_bit_equal(family_steps, arch):
    """The other families on the one-rank gloo mesh (vlm through the
    transformer's regions; whisper, RecurrentGemma and xLSTM through
    `rows_region`): a two-microbatch AdamW step with DTensor parameters,
    bit-equal to the unsharded port's."""
    assert family_steps[arch]
