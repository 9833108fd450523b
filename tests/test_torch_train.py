"""The port's training path against the JAX package's on the same inputs:
`softmax_xent`, every family's `loss_fn` and its gradients (per-layer
remat on), and `make_train_step` with and without microbatches.

The reference's parameters (`init(jax.random.key(0))`) are carried into
the port by `params_from_numpy`, bit for bit; batches are made with numpy
from a seed. Tolerances, fixed before the first run:

* `softmax_xent`: rel 1e-6 (float32, one logsumexp and one masked sum).
* `loss_fn` in float32: rel 1e-5; every gradient leaf: max |Δ| ≤ 1e-4 ×
  max |g_ref| (the forward tests' 1e-4), and zero wherever the reference's
  is zero (an embedding row no token reads, an expert no token reaches).
* `loss_fn` in bfloat16: rel 2^-6 (a few bf16 ulps through the layers).
* `make_train_step` with SGD: the loss rel 1e-5; the gradients handed to
  the optimizer within 1e-4 × max |g| a leaf (with two microbatches, also
  one bfloat16 rounding: the reference casts their mean to bf16), the new
  parameters within lr times that and one float32 rounding.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCH_IDS
from repro.models.common import softmax_xent as ref_xent
from repro.train import optim as ref_optim
from repro.train.trainer import make_train_step as ref_make_train_step
from repro_torch.models.common import softmax_xent, tree_leaves, tree_map
from repro_torch.train import optim
from repro_torch.train.trainer import make_train_step, value_and_grad

import _torch_parity as parity

LOSS_REL = 1e-5
GRAD_REL = 1e-4
BF16_LOSS_REL = 2.0 ** -6
f32 = parity.f32


def train_batches(cfg, B, S, seed):
    """The same training batch for both packages: the prefill inputs of
    `_torch_parity.batches` (whisper's frames as many as the tokens) and
    labels, among them 0 and V - 1."""
    jb, tb = parity.batches(cfg, B, S, seed, frames=S)
    rng = np.random.default_rng(seed + 1)
    labels = rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)
    labels[0, 1], labels[-1, -1] = 0, cfg.vocab_size - 1
    jb["labels"] = jnp.asarray(labels)
    tb["labels"] = torch.from_numpy(labels.astype(np.int64))
    return jb, tb


def port_loss_and_grads(tm, tp, tb, remat=True):
    loss, grads = value_and_grad(
        lambda p, b: tm.loss_fn(p, b, remat=remat), tp, tb)
    return loss, grads


def test_softmax_xent_matches_reference():
    rng = np.random.default_rng(0)
    B, S, V = 3, 7, 50
    logits = (rng.standard_normal((B, S, V)) * 4).astype(np.float32)
    labels = rng.integers(0, V, (B, S)).astype(np.int32)
    labels[0, 0], labels[2, 6] = 0, V - 1
    want = float(ref_xent(jnp.asarray(logits), jnp.asarray(labels), V))
    got = float(softmax_xent(torch.from_numpy(logits),
                             torch.from_numpy(labels.astype(np.int64)), V))
    assert abs(got - want) <= 1e-6 * abs(want)


def test_softmax_xent_gradient_is_dense():
    """The masked sum's gradient: softmax - one_hot(label) over B*S, with
    no scatter; labels at 0 and V - 1 included."""
    rng = np.random.default_rng(1)
    logits = torch.from_numpy(rng.standard_normal((2, 3, 9))
                              .astype(np.float32)).requires_grad_(True)
    labels = torch.tensor([[0, 8, 4], [8, 0, 1]])
    (g,) = torch.autograd.grad(softmax_xent(logits, labels, 9), logits)
    want = (torch.softmax(logits.detach(), -1)
            - torch.nn.functional.one_hot(labels, 9)) / 6
    torch.testing.assert_close(g, want, rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_loss_and_grads_match_reference(arch):
    rm, rp, tm, tp = parity.models(arch, "float32")
    jb, tb = train_batches(rm.cfg, 2, 16, seed=11)
    rloss, rgrads = jax.value_and_grad(lambda p: rm.loss_fn(p, jb))(rp)
    tloss, tgrads = port_loss_and_grads(tm, tp, tb)
    assert tloss.dtype == torch.float32 and tloss.shape == ()
    assert abs(float(tloss) - float(rloss)) <= LOSS_REL * abs(float(rloss))
    # the port's tree holds the reference's keys (params_from_numpy), so
    # leaves come in the same order
    got, want = tree_leaves(tgrads), jax.tree.leaves(rgrads)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        g, w = f32(g), f32(w)
        assert g.shape == w.shape
        assert np.isfinite(w).all() and np.isfinite(g).all()
        assert np.abs(g - w).max() <= GRAD_REL * np.abs(w).max()
        assert (g[w == 0] == 0).all()


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_bf16_loss_matches_reference(arch):
    rm, rp, tm, tp = parity.models(arch, "bfloat16")
    jb, tb = train_batches(rm.cfg, 2, 16, seed=12)
    want = float(rm.loss_fn(rp, jb))
    got = tm.loss_fn(tp, tb)
    assert got.dtype == torch.float32
    assert abs(float(got) - want) <= BF16_LOSS_REL * abs(want)


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_remat_gives_equal_bits(arch):
    """Recomputing each layer in the backward pass repeats the same ops:
    loss and gradients are bit-equal with remat on and off."""
    rm, _, tm, tp = parity.models(arch, "float32")
    _, tb = train_batches(rm.cfg, 2, 16, seed=13)
    on_loss, on = port_loss_and_grads(tm, tp, tb, remat=True)
    off_loss, off = port_loss_and_grads(tm, tp, tb, remat=False)
    assert torch.equal(on_loss, off_loss)
    for a, b in zip(tree_leaves(on), tree_leaves(off)):
        assert torch.equal(a, b)


def test_forward_remat_defaults():
    """The reference's defaults: `ModelApi.forward` without remat, the
    module's `forward` and `loss_fn` with it; equal logits either way."""
    import inspect
    from repro_torch.models import rglru, transformer, whisper, xlstm
    for mod in (transformer, whisper, rglru, xlstm):
        for fn in (mod.forward, mod.loss_fn):
            assert inspect.signature(fn).parameters["remat"].default is True
    rm, _, tm, tp = parity.models("phi4-mini-3.8b", "float32")
    _, tb = train_batches(rm.cfg, 2, 8, seed=14)
    assert inspect.signature(tm.forward).parameters["remat"].default is False
    assert torch.equal(tm.forward(tp, tb), tm.forward(tp, tb, remat=True))


def test_xlstm_running_max_differentiates_as_jax_cummax():
    """mLSTM's running max: the values of `torch.cummax`, and where a
    gradient is taken `jax.lax.cummax`'s, which splits the cotangent
    evenly between tied elements."""
    from repro_torch.models.xlstm import _running_max
    x = np.array([[1, 3, 3, 2, 3, 0, 5, 5, 5, 4, 6]], np.float32)[..., None]
    w = np.arange(1, 12, dtype=np.float32)[None, :, None]
    want = jax.grad(lambda v: (jax.lax.cummax(v, axis=1) * w).sum())(
        jnp.asarray(x))
    t = torch.from_numpy(x).requires_grad_(True)
    got = _running_max(t)
    (g,) = torch.autograd.grad((got * torch.from_numpy(w)).sum(), t)
    assert torch.equal(got.detach(), torch.cummax(t.detach(), 1).values)
    np.testing.assert_array_equal(g.numpy(), np.asarray(want))
    assert torch.equal(_running_max(t.detach()), got.detach())


def test_long_xlstm_chunk_gives_the_references_non_finite_gradients():
    """At 128 tokens a chunk's masked exp overflows where the mask drops
    it (the later keys' decay sums pass e^88), and 0 * inf makes the
    backward non-finite in the reference. The port adds no guard: the same
    leaves come out non-finite, the loss finite in both."""
    rm, rp, tm, tp = parity.models("xlstm-125m", "float32")
    jb, tb = train_batches(rm.cfg, 2, 128, seed=15)
    rloss, rgrads = jax.value_and_grad(lambda p: rm.loss_fn(p, jb))(rp)
    tloss, tgrads = port_loss_and_grads(tm, tp, tb)
    assert np.isfinite(float(rloss)) and np.isfinite(float(tloss))
    want = [not np.isfinite(f32(g)).all() for g in jax.tree.leaves(rgrads)]
    got = [not np.isfinite(f32(g)).all() for g in tree_leaves(tgrads)]
    assert any(want) and got == want


# ---------------------------------------------------------------------------
# the train step


class _Recorder:
    """Wraps an optimizer's update to record the gradients it is handed."""

    def __init__(self):
        self.grads = []

    def ref(self, opt):
        def update(grads, state, params):
            self.grads.append(jax.tree.leaves(grads))
            return opt.update(grads, state, params)
        return dataclasses.replace(opt, update=update)

    def port(self, opt):
        def update(grads, state, params):
            self.grads.append(tree_leaves(grads))
            return opt.update(grads, state, params)
        return dataclasses.replace(opt, update=update)

    def dtypes(self):
        return [{str(g.dtype).replace("torch.", "") for g in leaves}
                for leaves in self.grads]


def _bf16_ulp(x):
    """The spacing of bfloat16 numbers at |x| (float32's times 2^16)."""
    return np.spacing(np.abs(x).astype(np.float32)) * 2.0 ** 16


@pytest.mark.parametrize("arch", ["phi4-mini-3.8b", "xlstm-125m"])
@pytest.mark.parametrize("microbatches", [1, 2])
def test_train_step_matches_reference(arch, microbatches):
    """SGD through both packages' steps. Both hand the optimizer gradients
    in the parameter dtype with one microbatch and in bfloat16 with two
    (the reference's cast). Each gradient entry within 1e-4 × the leaf's
    max |g|; with two microbatches also one bfloat16 rounding (means that
    close can round to neighbouring bf16 values). The new parameters
    within lr times that, and one float32 rounding of the parameter."""
    lr = 0.1
    rm, rp, tm, tp = parity.models(arch, "float32")
    jb, tb = train_batches(rm.cfg, 4, 16, seed=16)
    rec_r, rec_t = _Recorder(), _Recorder()
    ropt = rec_r.ref(ref_optim.make_optimizer(
        ref_optim.OptimizerConfig(name="sgd", lr=lr)))
    topt = rec_t.port(optim.make_optimizer(
        optim.OptimizerConfig(name="sgd", lr=lr)))
    rloss, rnew, rstate = ref_make_train_step(
        rm, ropt, microbatches=microbatches)(rp, ropt.init(rp), jb)
    tloss, tnew, tstate = make_train_step(
        tm, topt, microbatches=microbatches)(tp, topt.init(tp), tb)
    want_dtype = {"bfloat16"} if microbatches > 1 else {"float32"}
    assert rec_r.dtypes() == rec_t.dtypes() == [want_dtype]
    assert abs(float(tloss) - float(rloss)) <= LOSS_REL * abs(float(rloss))
    assert int(tstate["count"]) == int(rstate["count"]) == 1
    for gr, gt, r, n in zip(rec_r.grads[0], rec_t.grads[0],
                            jax.tree.leaves(rnew), tree_leaves(tnew)):
        gr, gt, r, n = f32(gr), f32(gt), f32(r), f32(n)
        tol = GRAD_REL * np.abs(gr).max() + (
            _bf16_ulp(gr) if microbatches > 1 else 0.0)
        assert (np.abs(gt - gr) <= tol).all()
        assert (np.abs(n - r) <= lr * tol + np.spacing(np.abs(r))).all()


def test_train_step_leaves_the_callers_tensors_alone():
    rm, _, tm, tp = parity.models("xlstm-125m", "float32")
    _, tb = train_batches(rm.cfg, 2, 16, seed=17)
    before = tree_map(torch.clone, tp)
    opt = optim.make_optimizer(optim.OptimizerConfig(name="adamw"))
    state = opt.init(tp)
    make_train_step(tm, opt, microbatches=2)(tp, state, tb)
    for a, b in zip(tree_leaves(tp), tree_leaves(before)):
        assert torch.equal(a, b) and a.grad is None and not a.requires_grad
    assert int(state["count"]) == 0


def test_sharding_names_raise():
    """The sharding names are ported (tests/test_torch_sharding.py holds
    them to the reference's specs); what they refuse: an optimizer they do
    not know, and `grad_shardings` on parameters that are not DTensors."""
    from repro_torch.parallel import make_rules
    from repro_torch.train import (make_train_step as mts,
                                   opt_state_sharding,
                                   train_state_shardings)
    rm, _, tm, tp = parity.models("xlstm-125m", "float32")

    class Mesh:
        shape, axis_names = {"data": 2, "model": 2}, ("data", "model")
    rules = make_rules(Mesh())
    opt = optim.make_optimizer(optim.OptimizerConfig())
    ps, osd, ap, aos = train_state_shardings(rules, tm, opt)
    assert all(t.device.type == "meta" for t in tree_leaves([ap, aos]))
    assert set(osd) == {"m", "v", "count"}
    bad = dataclasses.replace(opt, cfg=dataclasses.replace(opt.cfg,
                                                            name="lion"))
    with pytest.raises(ValueError, match="lion"):
        opt_state_sharding(rules, bad, ap, tm.axes())
    jb, tb = train_batches(rm.cfg, 2, 16, seed=3)
    with pytest.raises(TypeError, match="DTensor"):
        mts(tm, opt, grad_shardings=ps)(tp, opt.init(tp), tb)


def test_train_inputs_match_reference():
    from repro.configs import get_config as ref_config
    from repro.models.registry import get_model as ref_model
    from repro_torch.configs import get_config
    from repro_torch.models import get_model
    for arch in ARCH_IDS:
        for B, S in ((2, 16), (1, 5000)):
            want = ref_model(ref_config(arch, smoke=True)).train_inputs(B, S)
            got = get_model(get_config(arch, smoke=True)).train_inputs(B, S)
            assert list(got) == list(want)
            for k in want:
                assert tuple(got[k].shape) == want[k].shape
                assert str(got[k].dtype).replace("torch.", "") == \
                    str(want[k].dtype)
                assert got[k].device.type == "meta"
