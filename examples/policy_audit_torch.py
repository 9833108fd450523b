"""Policy audit on the PyTorch port: sweep (policy x price-vector x budget)
on the replay engine and bracket it against the exact reference -- the
paper's Table-1 workflow, as `examples/policy_audit.py` runs it on the JAX
package. The sweep is published through the online metrics registry and
exported as JSON (`examples/out/policy_audit_torch_metrics.json`).

    PYTHONPATH=src python examples/policy_audit_torch.py               # card
    PYTHONPATH=src python examples/policy_audit_torch.py --device cpu
"""
import argparse
import pathlib

import numpy as np

from repro_torch.core import (PRICE_VECTORS, exact_opt_uniform, heterogeneity,
                              miss_costs, sweep_torch, twemcache_like)
from repro_torch.online import MetricsRegistry

OUT = pathlib.Path(__file__).resolve().parent / "out"


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None,
                    help="cuda (the default) or cpu")
    args = ap.parse_args()
    metrics = MetricsRegistry()
    tr = twemcache_like(n_requests=8000, seed=1)
    # page-cache view: audit the *cost* structure with uniform pages
    budgets = np.array([32, 64, 128, 256])
    names = list(PRICE_VECTORS)
    cost_matrix = np.stack([miss_costs(tr.sizes, PRICE_VECTORS[n])
                            for n in names])

    print("trace: twemcache-like,", tr.num_requests, "requests,",
          tr.num_objects, "objects, mean size",
          f"{tr.access_sizes().mean():.0f} B")
    print(f"\n{'price':16s} {'s*':>8s} {'H':>6s} | dollars by budget "
          f"{budgets.tolist()} (gdsf)")
    grid = sweep_torch(["gdsf", "lru"], tr.ids, cost_matrix, budgets,
                       num_objects=tr.num_objects, device=args.device)
    gdsf, lru = grid[0], grid[1]
    for i, n in enumerate(names):
        pv = PRICE_VECTORS[n]
        H = heterogeneity(tr.ids, cost_matrix[i])
        cells = " ".join(f"{d:9.4f}" for d in gdsf[i])
        print(f"{n:16s} {pv.crossover_bytes:8.0f} {H:6.2f} | {cells}")
        metrics.set_gauge(f"audit.{n}.sstar_bytes", pv.crossover_bytes)
        metrics.set_gauge(f"audit.{n}.heterogeneity", H)
        for k, b in enumerate(budgets):
            metrics.observe(f"audit.{n}.gdsf_dollars", float(gdsf[i][k]),
                            step=int(b))
            metrics.observe(f"audit.{n}.lru_dollars", float(lru[i][k]),
                            step=int(b))

    print("\nexact reference at B=64 (first price vector):")
    opt = exact_opt_uniform(tr.ids, cost_matrix[0], 64)
    print(f"  OPT ${opt.dollars:.4f}  vs gdsf ${gdsf[0][1]:.4f} "
          f"vs lru ${lru[0][1]:.4f}")
    metrics.set_gauge(f"audit.{names[0]}.opt_dollars_B64", opt.dollars)
    path = metrics.write_json(OUT / "policy_audit_torch_metrics.json")
    print(f"\nmetrics registry exported to {path}")


if __name__ == "__main__":
    main()
