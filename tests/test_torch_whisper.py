"""The port's encdec family (whisper-large-v3's backbone: a stub frontend,
a bidirectional encoder, a decoder with RoPE self-attention and
cross-attention) against the JAX package's on the same inputs, with the
reference's weights carried across. Tolerances: see _torch_parity.py."""
import numpy as np
import pytest
import torch

import repro.models.whisper as rwhisper
from repro.configs import get_config as ref_config
from repro.models.registry import get_model as ref_model
from repro.serve import Request as RefRequest
from repro.serve import ServeEngine as RefEngine
from repro_torch.configs import get_config
from repro_torch.models import get_model, whisper
from repro_torch.serve import Request, ServeEngine

from _torch_parity import (TOL, batches, check_abstract_caches, check_model,
                           check_param_defs, f32, models)

ARCH = "whisper-large-v3"


def test_param_defs_match():
    check_param_defs(ARCH)
    full = get_model(get_config(ARCH)).param_defs()
    assert full["enc_pos"].shape == (8192, 1280)
    assert len(full["encoder"]) == len(full["decoder"]) == 32


@pytest.mark.parametrize("dtype", list(TOL))
@pytest.mark.parametrize("frames", [30, 1500])
def test_encoder_matches_reference(dtype, frames):
    rm, rp, tm, tp = models(ARCH, dtype)
    jb, tb = batches(rm.cfg, 2, 4, seed=3, frames=frames)
    np.testing.assert_allclose(
        f32(whisper.encode(tm.cfg, tp, tb["frames"])),
        f32(rwhisper.encode(rm.cfg, rp, jb["frames"])), **TOL[dtype])


@pytest.mark.parametrize("dtype", list(TOL))
@pytest.mark.parametrize("S", [12, 1])
def test_model_matches_reference(dtype, S):
    check_model(ARCH, dtype, S)


@pytest.mark.parametrize("B,max_seq", [(2, 40), (1, 448)])
def test_abstract_caches_match(B, max_seq):
    check_abstract_caches(ARCH, B, max_seq)


def test_prefill_inputs_match():
    rm = ref_model(ref_config(ARCH, smoke=True))
    tm = get_model(get_config(ARCH, smoke=True))
    want, got = rm.prefill_inputs(3, 40), tm.prefill_inputs(3, 40)
    assert sorted(got) == sorted(want) == ["frames", "tokens"]
    for k in want:
        assert tuple(got[k].shape) == want[k].shape
    assert tuple(got["frames"].shape) == (3, 1500, 64)


def test_decode_keeps_the_cross_cache():
    """decode_step hands back the cross-attention caches it was given (the
    encoder output's keys and values, fixed after prefill)."""
    rm, _, tm, tp = models(ARCH, "float32")
    _, tb = batches(rm.cfg, 2, 6, seed=4)
    logits, caches = tm.prefill(tp, tb)
    from repro_torch.serve.engine import _grow
    caches = _grow(tm, caches, 8)
    _, new = tm.decode_step(tp, torch.argmax(logits, -1), caches, 6)
    for (_, _, ck, cv), (_, _, nk, nv) in zip(caches, new):
        assert nk is ck and nv is cv


def test_both_engines_raise_key_error():
    """The reference engine prefills tokens alone, so whisper's prefill
    finds no frames; the port's engine does the same."""
    rm, rp, tm, tp = models(ARCH, "float32")
    prompt = np.arange(8, dtype=np.int32)
    with pytest.raises(KeyError, match="frames"):
        RefEngine(rm, rp).serve([RefRequest(0, prompt, 2)])
    with pytest.raises(KeyError, match="frames"):
        ServeEngine(tm, tp, device="cpu").serve([Request(0, prompt, 2)])
