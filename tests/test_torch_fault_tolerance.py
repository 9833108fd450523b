"""tests/test_fault_tolerance.py on the port, on the CPU: crash mid-run,
resume, and land bit-identically where an uninterrupted run lands; and
checkpoints that load across the two packages, bf16 included, with the
same manifest."""
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.train.checkpoint import load_checkpoint as ref_load
from repro.train.checkpoint import save_checkpoint as ref_save
from repro_torch.configs import get_config
from repro_torch.egress.cache import EgressCache
from repro_torch.egress.store import ObjectStore
from repro_torch.models.common import tree_leaves
from repro_torch.models.convert import tensor_to_numpy
from repro_torch.models.registry import get_model
from repro_torch.train.checkpoint import (latest_step, load_checkpoint,
                                          save_checkpoint)
from repro_torch.train.data import DataPipeline, ShardedTokenDataset
from repro_torch.train.driver import (DriverConfig, FailureInjector,
                                      TrainDriver)
from repro_torch.train.optim import OptimizerConfig, make_optimizer
from repro_torch.train.trainer import make_train_step


def _setup(tmp_path, max_steps=12, ckpt_every=4):
    cfg = get_config("xlstm-125m", smoke=True)
    model = get_model(cfg)
    opt = make_optimizer(OptimizerConfig(name="adamw", lr=1e-3))
    params = model.init(0, device="cpu")
    opt_state = opt.init(params)
    step = make_train_step(model, opt)
    store = ObjectStore("s3_internet")
    ds = ShardedTokenDataset(store, num_shards=4, shard_tokens=2048,
                             vocab=cfg.vocab_size).register()
    cache = EgressCache(store, capacity_bytes=4 * 2048 * 4, policy="gdsf")
    pipe = DataPipeline(ds, cache, batch_size=2, seq_len=16)
    driver = TrainDriver(
        DriverConfig(checkpoint_dir=str(tmp_path), max_steps=max_steps,
                     checkpoint_every=ckpt_every),
        step, params, opt_state, pipe, device="cpu")
    return driver


def _bits(t: torch.Tensor) -> np.ndarray:
    return tensor_to_numpy(t).reshape(-1).view(np.uint8)


def test_checkpoint_roundtrip(tmp_path):
    tree = {"a": torch.arange(12).reshape(3, 4).to(torch.bfloat16),
            "b": [torch.ones(5), {"c": torch.zeros((2, 2),
                                                   dtype=torch.int32)}]}
    save_checkpoint(tmp_path, 7, tree, extra={"x": 1})
    assert latest_step(tmp_path) == 7
    like = {"a": torch.empty((3, 4), dtype=torch.bfloat16, device="meta"),
            "b": [torch.empty(5, device="meta"),
                  {"c": torch.empty((2, 2), dtype=torch.int32,
                                    device="meta")}]}
    got, extra = load_checkpoint(tmp_path, 7, like, device="cpu")
    assert extra == {"x": 1}
    for a, b in zip(tree_leaves(tree), tree_leaves(got)):
        assert a.dtype == b.dtype and torch.equal(a, b)


def test_crash_resume_is_bit_identical(tmp_path):
    # uninterrupted reference run
    ref = _setup(tmp_path / "ref")
    ref_out = ref.run()

    # crashing run: injected failure at step 9 (after a checkpoint at 8)
    crash = _setup(tmp_path / "crash")
    crash.failure = FailureInjector(fail_at=(9,))
    with pytest.raises(RuntimeError, match="injected node failure"):
        crash.run()

    # "new process": rebuild everything, resume from disk
    resumed = _setup(tmp_path / "crash")
    assert resumed.resume()
    assert resumed.step == 8          # last complete checkpoint
    out = resumed.run()

    assert out["steps"] == ref_out["steps"]
    np.testing.assert_allclose(out["final_loss"], ref_out["final_loss"],
                               rtol=0, atol=0)
    # parameters and optimizer state bit-identical too
    for a, b in zip(tree_leaves([ref.params, ref.opt_state]),
                    tree_leaves([resumed.params, resumed.opt_state])):
        np.testing.assert_array_equal(_bits(a), _bits(b))


def test_data_pipeline_state_resumes(tmp_path):
    store = ObjectStore("s3_internet")
    ds = ShardedTokenDataset(store, num_shards=3, shard_tokens=1024,
                             vocab=100).register()
    cache = EgressCache(store, capacity_bytes=1 << 20, policy="lru")
    p1 = DataPipeline(ds, cache, batch_size=2, seq_len=8)
    b1 = p1.next_batch()
    state = p1.state()
    b2 = p1.next_batch()
    # restore into a fresh pipeline -> identical next batch
    p2 = DataPipeline(ds, EgressCache(store, 1 << 20, "lru"), 2, 8)
    p2.restore(state)
    b2b = p2.next_batch()
    np.testing.assert_array_equal(b2["tokens"], b2b["tokens"])


def test_straggler_detection(tmp_path):
    import time
    driver = _setup(tmp_path, max_steps=10, ckpt_every=100)
    seen = []
    driver.on_straggler = lambda s, ratio: seen.append((s, ratio))
    orig = driver.train_step

    calls = {"n": 0}

    def slow_step(p, o, b):
        calls["n"] += 1
        if calls["n"] == 8:
            # simulated slow host: 1 s, as the reference's test, and at
            # least 4x every earlier step (the port's eager step on a busy
            # CPU can take a good part of a second)
            time.sleep(max(1.0, 4 * max(driver.step_times)))
        return orig(p, o, b)

    driver.train_step = slow_step
    out = driver.run()
    assert out["stragglers"], "slow step not flagged"
    assert seen and seen[0][1] > driver.cfg.straggler_factor


# ---------------------------------------------------------------------------
# across the packages


def _trees():
    """The same tree for both packages: bf16, float32 and int32 leaves,
    dict keys out of sorted order, a list and a 0-d leaf."""
    rng = np.random.default_rng(0)
    w = rng.standard_normal((3, 4)).astype(np.float32)
    v = rng.standard_normal(5).astype(np.float32)
    ref = {"params": {"wq": jnp.asarray(w, jnp.bfloat16),
                      "layers": [{"b": jnp.asarray(v)}, {"b": jnp.asarray(-v)}]},
           "opt": {"count": jnp.asarray(3, jnp.int32),
                   "m": jnp.asarray(w * 2)}}
    port = {"params": {"wq": torch.from_numpy(w).to(torch.bfloat16),
                       "layers": [{"b": torch.from_numpy(v)},
                                  {"b": torch.from_numpy(-v)}]},
            "opt": {"count": torch.tensor(3, dtype=torch.int32),
                    "m": torch.from_numpy(w * 2)}}
    return ref, port


def _same_bits(port_tree, ref_tree):
    flat, _ = jax.tree_util.tree_flatten_with_path(ref_tree)
    assert len(flat) == len(tree_leaves(port_tree))
    # the port's tree, walked by the reference's paths
    for path, r in flat:
        t = port_tree
        for k in path:
            t = t[k.key] if hasattr(k, "key") else t[k.idx]
        r = np.asarray(r)
        assert str(t.dtype).replace("torch.", "") == str(r.dtype)
        assert tuple(t.shape) == r.shape
        want = r.view(np.uint16) if r.dtype.name == "bfloat16" else r
        np.testing.assert_array_equal(tensor_to_numpy(t), want)


def test_checkpoints_load_across_packages(tmp_path):
    ref_tree, port_tree = _trees()
    save_checkpoint(tmp_path / "port", 5, port_tree, extra={"k": [1, 2]})
    got, extra = ref_load(tmp_path / "port", 5, ref_tree)
    assert extra == {"k": [1, 2]}
    _same_bits(port_tree, got)

    ref_save(tmp_path / "ref", 6, ref_tree, extra={"k": 3})
    got, extra = load_checkpoint(tmp_path / "ref", 6, port_tree,
                                 device="cpu")
    assert extra == {"k": 3}
    _same_bits(got, ref_tree)
    assert list(got) == list(port_tree)          # the like tree's key order


def test_manifests_are_equal(tmp_path):
    ref_tree, port_tree = _trees()
    save_checkpoint(tmp_path / "port", 2, port_tree, extra={"a": 1})
    ref_save(tmp_path / "ref", 2, ref_tree, extra={"a": 1})
    read = [json.loads((tmp_path / d / "step_00000002" / "manifest.json")
                       .read_text()) for d in ("port", "ref")]
    assert read[0] == read[1]
    assert [rec["path"] for rec in read[0]["leaves"]] == [
        "['opt']['count']", "['opt']['m']", "['params']['layers'][0]['b']",
        "['params']['layers'][1]['b']", "['params']['wq']"]
    for rec in read[0]["leaves"]:
        a = np.load(tmp_path / "port" / "step_00000002" / rec["file"])
        b = np.load(tmp_path / "ref" / "step_00000002" / rec["file"])
        assert a.dtype == b.dtype and np.array_equal(a, b)
