"""Fleet governance on the PyTorch port, end to end: four edge hosts, one
quorum swap, as `examples/fleet_governance.py` runs it on the JAX package.

Replays the partitioned regime-shift scenario (DESIGN.md §10): four hosts
hash-partition a trace whose price vector flips across s* = f/e mid-
stream. Each host replays its partition against a metadata-only shadow
panel, closes event-time windows as its watermark advances, and gossips
`WindowDelta`s over a faulty in-process network (drops, duplicates,
reordering, delays). The coordinator quorum-swaps the fleet-wide policy
when a majority of the shadow-dollar-weighted votes agrees — then the
fleet's realized bill is reconciled three independent ways:

  * fsum over per-node BillingMeters  (what the hosts were billed)
  * fsum over per-node exact audits   (what the offline reference saw)
  * per-node wire-log replays         (what crossed the wire, re-accrued)

all bit-equal, and the governed fleet lands within 10% of the best fixed
policy chosen in hindsight.

Fleet governance is host code (no tensor is made); `--device` only picks
the device of a closing check: the same scenario served through the
engine's fleet mode on the qwen2-moe smoke model, whose bill reconciles
the same ways.

    PYTHONPATH=src python examples/fleet_governance_torch.py               # card
    PYTHONPATH=src python examples/fleet_governance_torch.py --device cpu
"""
import argparse
import math

import numpy as np

from repro_torch.configs import get_config
from repro_torch.core import resolve_device
from repro_torch.egress.cache import EgressCache, ONLINE_POLICIES
from repro_torch.fleet import Fleet, SimNetwork, hash_partition
from repro_torch.models import get_model
from repro_torch.online.scenario import regime_shift_scenario
from repro_torch.serve.engine import Request, ServeEngine

N = 4
SCENARIO = dict(n_phase=3000, seed=0, n_big_active=12, big_bytes=1 << 18)


def run_fixed(sc, policy):
    store = sc.make_store()
    caches = [EgressCache(store, sc.capacity_bytes / N, policy,
                          consumer=f"edge{i}") for i in range(N)]
    for t, key in enumerate(sc.keys):
        if t == sc.flip_at:
            store.set_price(sc.price_b)
        caches[hash_partition(key, N)].get(key)
    return math.fsum(c.meter.dollars for c in caches)


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None,
                    help="cuda (the default) or cpu")
    args = ap.parse_args()
    device = resolve_device(args.device)
    sc = regime_shift_scenario(**SCENARIO)
    print(f"trace: {sc.num_requests} requests over {N} hosts, "
          f"price flips {sc.price_a.name} -> {sc.price_b.name} "
          f"at t={sc.flip_at}")

    fixed = {p: run_fixed(sc, p) for p in ONLINE_POLICIES}
    best = min(fixed, key=fixed.get)
    print("\nfixed-policy fleets (hindsight):")
    for p, d in sorted(fixed.items(), key=lambda kv: kv[1]):
        mark = "  <- best fixed" if p == best else ""
        print(f"  {p:5s} ${d:.6f}{mark}")

    net = SimNetwork(seed=3, drop=0.25, duplicate=0.3, reorder=0.5,
                     max_delay=2)
    store = sc.make_store()
    fleet = Fleet(store=store, n_nodes=N,
                  capacity_bytes=sc.capacity_bytes / N, policy="lru",
                  window_span=400.0, max_skew=32.0, gossip_every=100,
                  network=net)
    for t, key in enumerate(sc.keys):
        if t == sc.flip_at:
            store.set_price(sc.price_b)
        fleet.access(key, event_time=t)
    converged = fleet.flush()

    print(f"\ngoverned fleet (starts lru, faulty network):")
    for s in fleet.swaps:
        print(f"  window {s.window_id}: {s.old_policy} -> {s.new_policy} "
              f"({s.mode}, round {s.round})")
        for h, (vote, weight) in sorted(s.votes.items()):
            print(f"    {h}: votes {vote:5s} weight=${weight:.6f}")
    ns = net.snapshot()
    print(f"  network: {ns['sent']} sent, {ns['dropped']} dropped, "
          f"{ns['duplicated']} duplicated, {ns['reordered']} reordered; "
          f"converged={converged}")

    meters = fleet.dollars()
    audits = math.fsum(a.observed_dollars for a in fleet.audits().values())
    replays = math.fsum(n.replayed_dollars() for n in fleet.nodes)
    print(f"\nbilling identity (bit-equal):")
    print(f"  fsum(node meters)   ${meters!r}")
    print(f"  fsum(node audits)   ${audits!r}")
    print(f"  fsum(wire replays)  ${replays!r}")
    assert meters == audits == replays

    reg = (meters - fixed[best]) / fixed[best]
    print(f"\ngoverned ${meters:.6f} vs best fixed ({best}) "
          f"${fixed[best]:.6f}: regret {reg:+.1%} (within 10%: "
          f"{reg <= 0.10})")
    assert reg <= 0.10
    assert {n.cache.policy for n in fleet.nodes} == {fleet.policy}
    print(f"unanimous fleet policy: {fleet.policy}")
    serve_fleet(device)


def serve_fleet(device):
    """Prefix caches of a fleet-mode engine: three hosts, qwen2-moe's smoke
    model on `device`, prompts drawn from a skewed pool of six (hashed to
    hosts 1, 0, 1, 0, 2, 0); each host holds two 4 KiB prefix blobs."""
    cfg = get_config("qwen2-moe-a2.7b", smoke=True)
    model = get_model(cfg)
    engine = ServeEngine(model, model.init(0, device=device),
                         prefix_cache_bytes=3 * 2 * 4096, policy="gdsf",
                         fleet_nodes=3, governor_window=4, device=device)
    rng = np.random.default_rng(1)
    pool = [rng.integers(0, cfg.vocab_size, 16).astype(np.int32)
            for _ in range(6)]
    rid = 0
    for _ in range(8):
        picks = rng.choice(6, 3, p=[.35, .25, .15, .1, .1, .05])
        engine.serve([Request(rid + j, pool[i], 2)
                       for j, i in enumerate(picks)])
        rid += len(picks)
    fleet = engine.fleet
    audits = [a for a in engine.audit().values() if a is not None]
    observed = math.fsum(a.observed_dollars for a in audits)
    print(f"\nfleet-mode engine ({cfg.name} on {device.type}): {rid} "
          f"requests, {engine.store.meter.gets} GETs over 3 hosts")
    for n in fleet.nodes:
        print(f"  {n.host}: {n.cache.hits} hits, {n.cache.misses} misses, "
              f"${n.cache.meter.dollars!r}")
    print(f"  fsum(node meters) ${fleet.dollars()!r} == fsum(audits) "
          f"${observed!r} == store ${engine.store.meter.dollars!r}")
    assert fleet.dollars() == observed == engine.store.meter.dollars
    for n in fleet.nodes:
        assert n.cache.meter.gets == n.cache.misses


if __name__ == "__main__":
    main()
