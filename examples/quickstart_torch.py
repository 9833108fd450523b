"""Quickstart on the PyTorch port: the paper in five minutes, as
`examples/quickstart.py` runs it on the JAX package.

1. Build a workload (synthetic Zipf trace), price it under real cloud
   billing (eq. 1), and locate the GET-fee/egress crossover s* (eq. 3).
2. Compute the EXACT offline dollar-optimum (interval LP == min-cost flow).
3. Score the policy panel in dollars against it: on the host simulator and
   on the device replay (`sweep_torch`), which must agree (equal hits,
   dollars to rel 1e-5: the replay keeps costs in float32).

    PYTHONPATH=src python examples/quickstart_torch.py                # card
    PYTHONPATH=src python examples/quickstart_torch.py --device cpu
"""
import argparse

import numpy as np

from repro_torch.core import (PRICE_VECTORS, Trace, exact_opt_uniform,
                              heterogeneity, regret, resolve_device, simulate,
                              sweep_torch)

POLICIES = ("lru", "lfu", "gds", "gdsf", "belady", "cost_belady")


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None,
                    help="cuda (the default) or cpu")
    args = ap.parse_args()
    device = resolve_device(args.device)
    print("=== cloud-egress caching quickstart ===\n")
    # a page-cache workload: uniform 4 KiB pages, heterogeneous miss costs
    # (same-region vs cross-region objects — cost varies, size doesn't)
    rng = np.random.default_rng(0)
    n_objects, T, B = 200, 8000, 24
    ids = rng.choice(n_objects, size=T,
                     p=(lambda p: p / p.sum())(
                         np.arange(1, n_objects + 1.) ** -0.9)).astype(np.int32)
    costs = np.exp(rng.normal(0, 2.0, n_objects))   # heterogeneous $ / miss
    tr = Trace(ids=ids, sizes=np.ones(n_objects), name="quickstart")

    H = heterogeneity(ids, costs)
    print(f"workload: {T} requests over {n_objects} pages, budget {B} pages")
    print(f"miss-cost heterogeneity H = {H:.2f}\n")

    for pv in PRICE_VECTORS.values():
        print(f"  {pv.name:16s} GET=${pv.get_fee:.2e}  "
              f"egress=${pv.egress_per_byte * 1e9:.3f}/GB  "
              f"crossover s* = {pv.crossover_bytes:,.0f} B")
    print()

    opt = exact_opt_uniform(ids, costs, B)
    print(f"exact offline dollar-optimum: ${opt.dollars:,.2f} "
          f"(no-cache ${opt.total_no_cache:,.2f}, "
          f"{opt.hits} retained reuses)\n")

    # the whole panel in one replay on the device: (Q, 1 price row, 1 budget)
    dev_dollars, dev_hits = sweep_torch(
        list(POLICIES), ids, costs[None, :], np.array([B]),
        num_objects=n_objects, device=device, return_hits=True)
    print(f"  {'policy':12s} {'host $':>11s} {'replay $':>11s} "
          f"({device.type})  dollar-regret  hit-rate")
    for q, policy in enumerate(POLICIES):
        r = simulate(policy, tr, costs, float(B))
        d, h = float(dev_dollars[q, 0, 0]), int(dev_hits[q, 0, 0])
        print(f"  {policy:12s} ${r.dollars:10,.2f} ${d:10,.2f}   "
              f"{regret(r.dollars, opt.dollars):6.3f}   "
              f"{r.hits / tr.num_requests:.3f}")
        assert h == r.hits and abs(d - r.dollars) <= 1e-5 * r.dollars, \
            f"{policy}: the replay disagrees with the host simulator"
    print("\ncost-blind LRU leaves money on the table; GDSF buys most of "
          "it back (paper Fig. 1).")


if __name__ == "__main__":
    main()
