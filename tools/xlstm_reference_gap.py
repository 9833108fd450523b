"""The reference's own decode-against-forward gap for xLSTM.

    JAX_PLATFORMS=cpu PYTHONPATH=src python3 tools/xlstm_reference_gap.py [S]

Runs the JAX package's xlstm-125m at full width in bf16 (weights from
`jax.random.key(1)`, S + 1 tokens from numpy's seed 1, S = 512 by
default): `decode_step` token by token from `init_state` over the tokens
(jitted, as the reference's engine runs it), against `forward`'s last
logits (the chunkwise form). Prints one JSON line with the max gap, the
largest logit and their ratio. `chip_smoke.py`'s families_numerics (a)
sets xLSTM's tolerance from this ratio.
"""
import json
import sys
import time

import jax
import jax.numpy as jnp
import numpy as np

from repro.configs import get_config
from repro.models import xlstm
from repro.models.registry import get_model


def main() -> int:
    S = int(sys.argv[1]) if len(sys.argv) > 1 else 512
    cfg = get_config("xlstm-125m")
    model = get_model(cfg)
    params = model.init(jax.random.key(1))
    rng = np.random.default_rng(1)
    toks = jnp.asarray(rng.integers(0, cfg.vocab_size, (1, S + 1)), jnp.int32)
    t0 = time.perf_counter()
    full = np.asarray(model.forward(params, {"tokens": toks})[:, -1],
                      np.float32)
    decode = jax.jit(lambda p, t, s, i: model.decode_step(p, t, s, i))
    states = xlstm.init_state(cfg, 1, cfg.param_dtype)
    for t in range(S + 1):
        logits, states = decode(params, toks[:, t], states, jnp.int32(t))
    logits = np.asarray(logits, np.float32)
    gap = float(np.abs(logits - full).max())
    largest = float(np.abs(full).max())
    print(json.dumps(dict(arch=cfg.name, dtype="bfloat16", tokens=S + 1,
                          max_abs_gap=gap, largest_logit=largest,
                          rel_gap=gap / largest,
                          same_greedy_token=int(logits.argmax())
                          == int(full.argmax()),
                          seconds=time.perf_counter() - t0)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
