"""The reference's own xLSTM gradients at the training lengths.

    JAX_PLATFORMS=cpu PYTHONPATH=src python3 tools/xlstm_train_nan.py [S ...]

Runs the JAX package's xlstm-125m at full width in bf16 (weights from
`jax.random.key(0)`, as `examples/train_100m.py` draws them) and, for each
S (128 and 64 by default), the first batch of that example's billed data
pipeline at 8 x S tokens, split into its two microbatches as
`make_train_step` splits it: `jax.value_and_grad` of `loss_fn` (remat on)
for each. Prints one JSON line a length: the loss and how many of the
gradient leaves hold a non-finite value. At 128 tokens a chunk's masked
`exp` overflows where the causal mask drops it (the forget gates' decay
sums pass e^88), and 0 * inf makes the backward non-finite; the loss
stays finite. `chip_smoke.py`'s train_xlstm runs both lengths.
"""
import json
import sys
import time

import jax
import jax.numpy as jnp

from repro.configs import get_config
from repro.egress.cache import EgressCache
from repro.egress.store import ObjectStore
from repro.models.registry import get_model
from repro.train.data import DataPipeline, ShardedTokenDataset


def main() -> int:
    lengths = [int(a) for a in sys.argv[1:]] or [128, 64]
    cfg = get_config("xlstm-125m")
    model = get_model(cfg)
    params = model.init(jax.random.key(0))
    grad = jax.jit(jax.value_and_grad(lambda p, b: model.loss_fn(p, b)))
    B = 8
    for S in lengths:
        t0 = time.perf_counter()
        store = ObjectStore("gcs_internet")
        ds = ShardedTokenDataset(store, num_shards=64, shard_tokens=B * S * 4,
                                 vocab=cfg.vocab_size).register()
        cache = EgressCache(store, capacity_bytes=8 * B * S * 4 * 4,
                            policy="gdsf")
        batch = DataPipeline(ds, cache, B, S).next_batch()
        out = []
        for half in (slice(0, B // 2), slice(B // 2, B)):
            mb = {k: jnp.asarray(v[half]) for k, v in batch.items()}
            loss, g = grad(params, mb)
            leaves = jax.tree.leaves(g)
            bad = sum(not bool(jnp.isfinite(x.astype(jnp.float32)).all())
                      for x in leaves)
            out.append(dict(loss=float(loss), nonfinite_grad_leaves=bad,
                            grad_leaves=len(leaves)))
        print(json.dumps(dict(arch=cfg.name, dtype="bfloat16", batch=B,
                              seq=S, microbatches=out,
                              seconds=time.perf_counter() - t0)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
