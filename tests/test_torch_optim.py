"""The port's optimizers against the JAX package's: three updates from the
same numpy parameters and gradients through both, every parameter and
state leaf within rel 1e-6 (max |Δ| ≤ 1e-6 × max |reference|, float32 math
in the same order in both), `count` equal. Parameters mix float32 and
bfloat16 leaves, so the casts to float32 and back are exercised."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.train import optim as ref_optim
from repro_torch.models.common import tree_leaves
from repro_torch.models.convert import params_from_numpy
from repro_torch.train import optim

REL = 1e-6
SHAPES = {"w": (6, 5), "b": (5,), "emb": (9, 3),
          "layers": [{"k": (3, 4, 6), "g": (8,)}, {"k": (3, 4, 6), "g": (8,)}]}
BF16 = {"emb"}


def _tree(rng, scale):
    def make(name, shape):
        a = (rng.standard_normal(shape) * scale).astype(np.float32)
        return jnp.asarray(a, jnp.bfloat16 if name in BF16 else jnp.float32)
    return {k: ([{n: make(n, s) for n, s in layer.items()} for layer in v]
                if isinstance(v, list) else make(k, v))
            for k, v in SHAPES.items()}


def _np(tree):
    return jax.tree.map(np.asarray, tree)


CASES = {
    "adamw_f32": dict(name="adamw", lr=1e-2),
    "adamw_bf16": dict(name="adamw", lr=1e-2),
    # factored: (6, 5) and the (3, 4, 6) stacks' last two dims at min 4;
    # the vectors and (9, 3) unfactored; clip 0.05 keeps the RMS clipping
    # active
    "adafactor": dict(name="adafactor", lr=1e-2, factored_min_dim=4,
                      clip_threshold=0.05),
    "sgd": dict(name="sgd", lr=1e-1),
}


@pytest.mark.parametrize("case", list(CASES))
def test_three_updates_match_reference(case):
    kw = CASES[case]
    bf16 = case == "adamw_bf16"
    ropt = ref_optim.make_optimizer(ref_optim.OptimizerConfig(
        **kw, **({"moment_dtype": jnp.bfloat16} if bf16 else {})))
    topt = optim.make_optimizer(optim.OptimizerConfig(
        **kw, **({"moment_dtype": torch.bfloat16} if bf16 else {})))
    rng = np.random.default_rng(3)
    rp = _tree(rng, 0.5)
    tp = params_from_numpy(_np(rp), "cpu")
    rs, ts = ropt.init(rp), topt.init(tp)
    noclip = optim.make_optimizer(optim.OptimizerConfig(
        **dict(kw, clip_threshold=float("inf"))))
    for step in range(3):
        g = _tree(rng, (1.0, 0.3, 2.0)[step])
        tg = params_from_numpy(_np(g), "cpu")
        if case == "adafactor":
            # the clipping is active: without it every float32 leaf moves
            # otherwise (the bfloat16 one may round to the same value)
            free, _ = noclip.update(tg, ts, tp)
        rp, rs = ropt.update(g, rs, rp)
        tp, ts = topt.update(tg, ts, tp)
        _assert_close(tp, rp)
        _assert_close(ts, rs)
        assert int(ts["count"]) == int(rs["count"]) == step + 1
        assert ts["count"].dtype == torch.int32
        if case == "adafactor":
            assert not any(torch.equal(a, b) for a, b in
                           zip(tree_leaves(free), tree_leaves(tp))
                           if a.dtype == torch.float32)
    if case == "adafactor":
        stats = ts["stats"]
        assert set(stats["w"]) == {"vr", "vc"}
        assert set(stats["layers"][0]["k"]) == {"vr", "vc"}
        assert set(stats["b"]) == set(stats["emb"]) == {"v"}


def test_update_leaves_its_inputs_alone():
    topt = optim.make_optimizer(optim.OptimizerConfig(name="adamw"))
    rng = np.random.default_rng(4)
    tp = params_from_numpy(_np(_tree(rng, 0.5)), "cpu")
    tg = params_from_numpy(_np(_tree(rng, 1.0)), "cpu")
    ts = topt.init(tp)
    before = [t.clone() for t in tree_leaves([tp, tg, ts])]
    topt.update(tg, ts, tp)
    assert all(torch.equal(a, b) for a, b in
               zip(tree_leaves([tp, tg, ts]), before))


def _assert_close(port_tree, ref_tree):
    """Leaf by leaf in JAX's order (the port's trees hold the reference's
    keys), dtypes equal, max |Δ| ≤ REL × max |reference|."""
    want = jax.tree.leaves(ref_tree)
    got = _jax_order(port_tree)
    assert len(got) == len(want)
    for t, r in zip(got, want):
        assert str(t.dtype).replace("torch.", "") == str(r.dtype)
        t = t.float().numpy()
        r = np.asarray(r, np.float32)
        assert t.shape == r.shape
        assert np.abs(t - r).max() <= REL * np.abs(r).max()


def _jax_order(tree):
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _jax_order(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in _jax_order(v)]
    return [tree]
