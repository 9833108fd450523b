"""tests/test_smoke_archs.py on the port: every architecture's smoke
config, one forward with its loss, one gradient step, and a prefill
followed by decode steps on the CPU, shapes and finiteness asserted, with
the port's own weights (drawn from a torch.Generator)."""
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from repro_torch.configs import ARCH_IDS, get_config
from repro_torch.models import get_model, rglru, xlstm
from repro_torch.models.common import tree_leaves


def _batch(model, B=2, S=16, seed=0):
    cfg = model.cfg
    rng = np.random.default_rng(seed)
    batch = {
        "tokens": torch.from_numpy(rng.integers(0, cfg.vocab_size, (B, S))),
        "labels": torch.from_numpy(rng.integers(0, cfg.vocab_size, (B, S))),
    }
    if cfg.family == "vlm":
        batch["vision_embeds"] = torch.from_numpy(rng.standard_normal(
            (B, cfg.num_vision_tokens, cfg.d_model))).to(cfg.param_dtype)
    if cfg.family == "encdec":
        batch["frames"] = torch.from_numpy(rng.standard_normal(
            (B, S, cfg.d_model))).to(cfg.param_dtype)
    return batch


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_forward(arch):
    cfg = get_config(arch, smoke=True)
    model = get_model(cfg)
    params = model.init(0, device="cpu")
    batch = _batch(model)
    logits = model.forward(params, batch)
    assert logits.shape == (2, 16, cfg.vocab_size)
    assert logits.dtype == torch.float32
    assert bool(torch.isfinite(logits).all()), f"{arch}: non-finite logits"
    loss = model.loss_fn(params, batch)
    assert loss.shape == ()
    assert bool(torch.isfinite(loss)), f"{arch}: non-finite loss"
    # a one-hot-ish sanity: loss should be near log(V) at init
    assert 0.5 * np.log(cfg.vocab_size) < float(loss) \
        < 2.5 * np.log(cfg.vocab_size)
    # the next-token cross-entropy of the forward's logits, as an oracle
    xent = F.cross_entropy(logits[:, :-1].reshape(-1, cfg.vocab_size),
                           batch["labels"][:, 1:].reshape(-1))
    assert abs(float(loss) - float(xent)) <= 1e-5 * float(xent)


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_train_grad_step(arch):
    cfg = get_config(arch, smoke=True)
    model = get_model(cfg)
    params = model.init(1, device="cpu")
    batch = _batch(model)
    leaves = [t.requires_grad_(True) for t in tree_leaves(params)]
    loss = model.loss_fn(params, batch)
    grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    assert bool(torch.isfinite(loss))
    flat = [torch.zeros_like(t) if g is None else g
            for t, g in zip(leaves, grads)]
    assert all(bool(torch.isfinite(g).all()) for g in flat), \
        f"{arch}: bad grads"
    # at least one nonzero gradient leaf
    assert any(float(g.float().abs().max()) > 0 for g in flat)


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_prefill_then_decode(arch):
    cfg = get_config(arch, smoke=True)
    model = get_model(cfg)
    params = model.init(2, device="cpu")
    B, S = 2, 16
    pre_batch = _batch(model, B=B, S=S)
    pre_batch.pop("labels")
    logits, caches = model.prefill(params, pre_batch)
    assert logits.shape == (B, cfg.vocab_size)
    assert bool(torch.isfinite(logits).all())
    caches = _grow_caches(model, caches, S + 4)
    tok = torch.argmax(logits, -1)
    for step in range(2):
        logits, caches = model.decode_step(params, tok, caches, S + step)
        assert logits.shape == (B, cfg.vocab_size)
        assert bool(torch.isfinite(logits).all()), f"{arch}: step {step}"
        tok = torch.argmax(logits, -1)


def _grow_caches(model, caches, max_len):
    """test_smoke_archs.py's helper: pad preallocated KV caches with empty
    slots up to max_len (transformer and whisper families); recurrent
    families carry O(1) state; window-capped local caches shift and are
    left alone."""
    cfg = model.cfg

    def pad(t):
        return F.pad(t, (0, 0, 0, 0, 0, max_len - t.shape[1]))

    if cfg.family in ("dense", "moe", "vlm"):
        out = []
        for l, (k, v) in enumerate(caches):
            if cfg.window and k.shape[1] <= cfg.window and (
                    cfg.global_every <= 0 or not cfg.is_global_layer(l)):
                out.append((k, v))  # shift cache: fixed W slots
                continue
            out.append((pad(k), pad(v)))
        return out
    if cfg.family == "encdec":
        return [(pad(sk), pad(sv), ck, cv) for sk, sv, ck, cv in caches]
    return caches


def _decode_sequence(model, params, toks, caches):
    outs = []
    for t in range(toks.shape[1]):
        lg, caches = model.decode_step(params, toks[:, t], caches, t)
        outs.append(lg)
    return torch.stack(outs, 1)


def test_decode_matches_forward_xlstm():
    """Chunkwise-parallel form == recurrent decode form (xLSTM)."""
    cfg = get_config("xlstm-125m", smoke=True)
    model = get_model(cfg)
    params = model.init(3, device="cpu")
    toks = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab_size, (1, 12)))
    par = model.forward(params, {"tokens": toks})
    seq = _decode_sequence(model, params, toks,
                           xlstm.init_state(cfg, 1, cfg.param_dtype))
    np.testing.assert_allclose(par.float().numpy(), seq.float().numpy(),
                               rtol=0.05, atol=0.05)


def test_decode_matches_forward_rglru():
    """Associative-scan form == stepwise decode (RG-LRU hybrid)."""
    cfg = get_config("recurrentgemma-9b", smoke=True)
    model = get_model(cfg)
    params = model.init(4, device="cpu")
    toks = torch.from_numpy(np.random.default_rng(1).integers(
        0, cfg.vocab_size, (1, 9)))
    par = model.forward(params, {"tokens": toks})
    seq = _decode_sequence(model, params, toks,
                           rglru.init_caches(cfg, 1, 32, cfg.param_dtype))
    np.testing.assert_allclose(par.float().numpy(), seq.float().numpy(),
                               rtol=0.05, atol=0.05)


def test_gemma3_window_pattern():
    cfg = get_config("gemma3-4b")
    globals_ = [l for l in range(cfg.num_layers) if cfg.is_global_layer(l)]
    assert globals_ == [5, 11, 17, 23, 29]  # every 6th layer (5:1)


def test_rglru_pattern():
    cfg = get_config("recurrentgemma-9b")
    attn = [l for l in range(9) if cfg.is_attn_layer(l)]
    assert attn == [2, 5, 8]  # (rec, rec, attn) repeating


def test_kimi_first_layer_dense():
    cfg = get_config("kimi-k2-1t-a32b")
    assert not cfg.is_moe_layer(0)
    assert cfg.is_moe_layer(1) and cfg.is_moe_layer(60)
