"""Serving example on the PyTorch port: batched greedy decoding with an
egress-billed prefix cache, as `examples/serve_with_egress_cache.py` runs
it on the JAX package (gemma3-4b's smoke config, governed). Repeated
prompts re-fetch their prefix KV from cloud storage unless the
dollar-aware cache retains them; the audit scores the realized bill
against the exact offline reference.

    PYTHONPATH=src python examples/serve_with_egress_cache_torch.py      # card
    PYTHONPATH=src python examples/serve_with_egress_cache_torch.py --device cpu
"""
import argparse

import numpy as np

from repro_torch.configs import get_config
from repro_torch.core import resolve_device
from repro_torch.models import get_model
from repro_torch.serve.engine import Request, ServeEngine


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None,
                    help="cuda (the default) or cpu")
    args = ap.parse_args()
    device = resolve_device(args.device)
    cfg = get_config("gemma3-4b", smoke=True)
    model = get_model(cfg)
    params = model.init(0, device=device)
    engine = ServeEngine(model, params, prefix_cache_bytes=1 << 22,
                         policy="gdsf", govern=True, governor_window=8,
                         device=device)

    rng = np.random.default_rng(0)
    # a few hot prompts (shared prefixes) + a stream of cold ones, served in
    # rounds so repeats of a hot prefix touch the egress-billed prefix cache
    hot = [rng.integers(0, cfg.vocab_size, 16).astype(np.int32)
           for _ in range(3)]
    done = []
    rid = 0
    for round_ in range(6):
        reqs = [Request(rid + i, h, max_new_tokens=4)
                for i, h in enumerate(hot)]
        rid += len(hot)
        cold = rng.integers(0, cfg.vocab_size, 16).astype(np.int32)
        reqs.append(Request(rid, cold, max_new_tokens=4)); rid += 1
        done += engine.serve(reqs)
    print(f"served {len(done)} requests on {device}; sample output: "
          f"{done[0].output.tolist()}")
    print("\n--- prefix-cache egress audit ---")
    print(engine.audit().summary())
    print(f"store meter: {engine.store.meter.snapshot()}")
    print("\n--- online governance ---")
    win = engine.governor.audit()
    if win is not None:
        print(win.summary())
    gov = engine.governor.snapshot()
    print(f"governor: policy={gov['policy']} swaps={len(gov['swaps'])} "
          f"shadow $: " + ", ".join(f"{p}={s['dollars']:.6f}"
                                    for p, s in gov['shadow'].items()))


if __name__ == "__main__":
    main()
