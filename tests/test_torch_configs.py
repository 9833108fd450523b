"""The port's architecture configs against the JAX package's, field by
field (dtypes compared by name), and the shape cells they are run at."""
import dataclasses

import numpy as np
import pytest
import torch

import repro.configs as rcfg
import repro_torch.configs as tcfg


def _fields(cfg) -> dict:
    d = dataclasses.asdict(cfg)
    dt = d["param_dtype"]
    d["param_dtype"] = (str(dt).removeprefix("torch.")
                        if isinstance(dt, torch.dtype) else np.dtype(dt).name)
    return d


@pytest.mark.parametrize("smoke", [False, True])
@pytest.mark.parametrize("arch", rcfg.ARCH_IDS)
def test_config_fields_equal(arch, smoke):
    want = rcfg.get_config(arch, smoke=smoke)
    got = tcfg.get_config(arch, smoke=smoke)
    assert _fields(got) == _fields(want)
    assert _fields(got)["param_dtype"] == "bfloat16"
    assert (got.hd, got.q_per_kv) == (want.hd, want.q_per_kv)
    for layer in range(got.num_layers):
        assert got.is_moe_layer(layer) == want.is_moe_layer(layer)
        assert got.is_global_layer(layer) == want.is_global_layer(layer)
        assert got.is_attn_layer(layer) == want.is_attn_layer(layer)


def test_tables_equal():
    assert tcfg.ARCH_IDS == rcfg.ARCH_IDS
    assert tcfg.list_archs() == rcfg.list_archs()
    assert tcfg.SHAPES == rcfg.SHAPES
    assert tcfg.LONG_OK == rcfg.LONG_OK
    assert tcfg.cells() == rcfg.cells()
    for arch in rcfg.ARCH_IDS:
        for shape in rcfg.SHAPES:
            assert tcfg.shape_applicable(arch, shape) == \
                rcfg.shape_applicable(arch, shape)


def test_phi4_mini_full_width():
    """The configuration the card's serving phase runs: 32 layers at d_model
    3072, 24 heads over 8 KV heads of 128, d_ff 8192, vocab 200064."""
    cfg = tcfg.get_config("phi4-mini-3.8b")
    assert (cfg.num_layers, cfg.d_model, cfg.num_heads, cfg.num_kv_heads,
            cfg.hd, cfg.d_ff, cfg.vocab_size) == (32, 3072, 24, 8, 128, 8192,
                                                  200064)
    assert not cfg.tie_embeddings and cfg.family == "dense"
