"""The port's vlm family (qwen2-vl-72b's backbone: M-RoPE and a stub
vision prefix) against the JAX package's on the same inputs, with the
reference's weights carried across. Tolerances: see _torch_parity.py;
M-RoPE alone at rtol = atol = 1e-5, its positions exactly."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.models.common as rcommon
import repro.models.transformer as rtransformer
import repro_torch.models.common as tcommon
from repro.configs import get_config as ref_config
from repro.models.registry import get_model as ref_model
from repro.serve import Request as RefRequest
from repro.serve import ServeEngine as RefEngine
from repro_torch.configs import get_config
from repro_torch.models import get_model, transformer
from repro_torch.serve import Request, ServeEngine

from _torch_parity import (TOL, batches, check_abstract_caches, check_model,
                           check_param_defs, f32, models, token_pair)

ARCH = "qwen2-vl-72b"
PRIM = dict(rtol=1e-5, atol=1e-5)


def test_param_defs_match():
    check_param_defs(ARCH)


@pytest.mark.parametrize("sections,D,theta", [((2, 3, 3), 16, 1e4),
                                              ((16, 24, 24), 128, 1e6),
                                              ((4, 0, 4), 16, 1e4)])
def test_apply_mrope_matches(sections, D, theta):
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 7, 3, D)).astype(np.float32)
    pos = rng.integers(0, 5000, (3, 2, 7)).astype(np.int32)
    want = rcommon.apply_mrope(jnp.asarray(x), jnp.asarray(pos), sections,
                               theta)
    got = tcommon.apply_mrope(torch.from_numpy(x), torch.from_numpy(pos),
                              sections, theta)
    np.testing.assert_allclose(f32(got), f32(want), **PRIM)


@pytest.mark.parametrize("P,S", [(16, 24), (16, 16), (256, 512), (10, 13),
                                 (1, 4)])
def test_mrope_positions_match(P, S):
    import dataclasses
    rc = dataclasses.replace(ref_config(ARCH, smoke=True),
                             num_vision_tokens=P)
    tc = dataclasses.replace(get_config(ARCH, smoke=True),
                             num_vision_tokens=P)
    want = np.asarray(rtransformer._mrope_positions(rc, 2, S))
    got = transformer._mrope_positions(tc, 2, S, "cpu")
    assert got.dtype == torch.int32 and tuple(got.shape) == (3, 2, S)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("dtype", list(TOL))
@pytest.mark.parametrize("S", [16, 24])   # vision prefix alone; with text
def test_model_matches_reference(dtype, S):
    check_model(ARCH, dtype, S)


def test_decode_positions_run_ahead_of_prefill_as_the_reference():
    """Decode rotates all three streams by the write index S where prefill
    gave text token i the position i - P + 1: the reference's own jump
    (P - 1 ahead), reproduced, so decode against a longer prefill differs
    on both packages alike."""
    rm, rp, tm, tp = models(ARCH, "float32")
    S = 24
    jb, tb = batches(rm.cfg, 1, S + 1, seed=7)
    jshort = {k: (v[:, :S] if k == "tokens" else v) for k, v in jb.items()}
    tshort = {k: (v[:, :S] if k == "tokens" else v) for k, v in tb.items()}
    from repro.serve.engine import _grow as ref_grow
    from repro_torch.serve.engine import _grow
    _, rc = rm.prefill(rp, jshort)
    _, tc = tm.prefill(tp, tshort)
    nxt = jb["tokens"][:, S]
    rdec, _ = rm.decode_step(rp, nxt, ref_grow(rm, rc, S + 1), jnp.int32(S))
    tdec, _ = tm.decode_step(tp, token_pair(nxt), _grow(tm, tc, S + 1), S)
    rfull, _ = rm.prefill(rp, jb)
    tfull, _ = tm.prefill(tp, tb)
    np.testing.assert_allclose(f32(tdec), f32(rdec), **TOL["float32"])
    np.testing.assert_allclose(f32(tfull), f32(rfull), **TOL["float32"])
    ref_gap = np.abs(f32(rdec) - f32(rfull)).max()
    # the jump shows: far above float32's agreement of the two (~1e-7)
    assert ref_gap > 1e-5
    np.testing.assert_allclose(np.abs(f32(tdec) - f32(tfull)).max(),
                               ref_gap, rtol=1e-2)


def test_vision_prefix_replaces_the_first_tokens():
    rm, rp, tm, tp = models(ARCH, "float32")
    _, tb = batches(rm.cfg, 2, 20, seed=8)
    other = dict(tb, tokens=tb["tokens"].clone())
    other["tokens"][:, :rm.cfg.num_vision_tokens] = 0
    assert torch.equal(tm.forward(tp, tb), tm.forward(tp, other))


@pytest.mark.parametrize("B,max_seq", [(2, 40), (1, 7)])
def test_abstract_caches_match(B, max_seq):
    check_abstract_caches(ARCH, B, max_seq)


def test_prefill_inputs_match():
    rm = ref_model(ref_config(ARCH, smoke=True))
    tm = get_model(get_config(ARCH, smoke=True))
    want, got = rm.prefill_inputs(3, 40), tm.prefill_inputs(3, 40)
    assert sorted(got) == sorted(want) == ["tokens", "vision_embeds"]
    for k in want:
        assert tuple(got[k].shape) == want[k].shape
        assert got[k].device.type == "meta"
    assert got["vision_embeds"].dtype == torch.bfloat16


def test_both_engines_raise_key_error():
    """The reference engine prefills tokens alone, so the vlm family's
    prefill finds no vision embeddings; the port's engine does the same."""
    rm, rp, tm, tp = models(ARCH, "float32")
    prompt = np.arange(20, dtype=np.int32)
    with pytest.raises(KeyError, match="vision_embeds"):
        RefEngine(rm, rp).serve([RefRequest(0, prompt, 2)])
    with pytest.raises(KeyError, match="vision_embeds"):
        ServeEngine(tm, tp, device="cpu").serve([Request(0, prompt, 2)])
