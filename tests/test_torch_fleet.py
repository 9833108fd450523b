"""The port's fleet governance, regime-shift scenario and the engine's fleet
mode, against the JAX package's.

`repro_torch.fleet` and `repro_torch.online.scenario` are host copies
(checked by AST in test_torch_hostcopies.py); here the reference's fleet
tests (tests/test_fleet.py), its scenario tests (tests/test_online.py) and
its fleet-mode serve test (tests/test_serve.py) run on the port, and the
same inputs through both packages give the same bytes on the wire, the same
dollars bit for bit, the same swaps and the same audits. The engines'
tokens are compared on the MoE smoke config in float32, where both
packages pick the same greedy tokens (test_torch_moe.py holds their logits
to 1e-4).
"""
import binascii
import dataclasses
import json
import math
import pathlib
import struct

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.egress.cache as regress_cache
import repro.fleet as rfleet
import repro.online.scenario as rscenario
import repro_torch.fleet as tfleet
from repro.configs import get_config as ref_config
from repro.models.registry import get_model as ref_model
from repro.serve import Request as RefRequest
from repro.serve import ServeEngine as RefEngine
from repro_torch.configs import get_config
from repro_torch.egress.cache import EgressCache, ONLINE_POLICIES, AccessEvent
from repro_torch.egress.store import ObjectStore
from repro_torch.fleet import (FleetCoordinator, FleetNode,
                               GossipState, SimNetwork, WindowDelta,
                               WireError, access_event_from_json,
                               access_event_to_json, decode,
                               decode_access_event, decode_window_delta,
                               encode_access_event, encode_window_delta,
                               hash_partition)
from repro_torch.models import get_model, params_from_numpy
from repro_torch.obs import validate
from repro_torch.online import MetricsRegistry, Watermark
from repro_torch.online.scenario import (regime_shift_scenario, run_fixed,
                                         run_governed)
from repro_torch.serve import Request, ServeEngine

# tests/test_fleet.py's locked-in regime-shift parameters
SCENARIO = dict(n_phase=3000, seed=0, n_big_active=12, big_bytes=1 << 18)
N_NODES = 4
FLEET_KW = dict(window_span=400.0, max_skew=32.0, gossip_every=100)


def _run_fixed_fleet(sc, policy, n=N_NODES):
    """Fleet of fixed-policy caches over the hash-partitioned trace."""
    store = sc.make_store()
    caches = [EgressCache(store, sc.capacity_bytes / n, policy,
                          consumer=f"edge{i}") for i in range(n)]
    for t, key in enumerate(sc.keys):
        if t == sc.flip_at:
            store.set_price(sc.price_b)
        caches[hash_partition(key, n)].get(key)
    return math.fsum(c.meter.dollars for c in caches)


def _run_governed_fleet(pkg_fleet, sc, network=None, seed=1):
    store = sc.make_store()
    fleet = pkg_fleet.Fleet(store=store, n_nodes=N_NODES,
                            capacity_bytes=sc.capacity_bytes / N_NODES,
                            policy="lru", network=network, seed=seed,
                            **FLEET_KW)
    for t, key in enumerate(sc.keys):
        if t == sc.flip_at:
            store.set_price(sc.price_b)
        fleet.access(key, event_time=t)
    assert fleet.flush()
    return fleet


def _audits(by_host):
    """Per-host audits as dicts (None for a host that saw no access)."""
    return {h: None if a is None else dataclasses.asdict(a)
            for h, a in by_host.items()}


# ---------------------------------------------------------------------------
# wire format


def _fields(mc=0.09 + 1e-10):
    return ("obj/α-17", 123_456, False, mc, "gdsf", 42, 1234.5)


def _event(mc=0.09 + 1e-10):
    return AccessEvent(*_fields(mc))


def test_access_event_binary_round_trip_bit_equal():
    ev = _event()
    back = decode_access_event(encode_access_event(ev))
    assert back == ev
    assert math.copysign(1, back.miss_cost) == math.copysign(1, ev.miss_cost)
    assert back.miss_cost.hex() == ev.miss_cost.hex()


def test_access_event_json_round_trip_bit_equal():
    ev = _event(mc=0.1 + 0.2)
    assert access_event_from_json(access_event_to_json(ev)) == ev


def test_window_delta_round_trip():
    d = WindowDelta("edge3", 17, 9, 7231.0, 412,
                    {p: 0.001 * (i + 1) for i, p in enumerate(ONLINE_POLICIES)})
    assert decode_window_delta(encode_window_delta(d)) == d
    assert decode(encode_window_delta(d)) == d
    assert decode(encode_access_event(_event())) == _event()


def test_wire_rejects_corruption():
    frame = bytearray(encode_access_event(_event()))
    frame[10] ^= 0xFF
    with pytest.raises(WireError):
        decode_access_event(bytes(frame))
    with pytest.raises(WireError):
        decode_access_event(b"XX" + bytes(frame[2:]))
    with pytest.raises(WireError):
        decode_access_event(bytes(frame[:5]))
    wd = encode_window_delta(WindowDelta("h", 0, 1, 0.0, 0, {}))
    with pytest.raises(WireError):
        decode_access_event(wd)


def test_wire_rejects_future_version():
    frame = bytearray(encode_access_event(_event()))
    frame[2] += 1
    frame[-4:] = struct.pack("<I", binascii.crc32(bytes(frame[:-4])))
    with pytest.raises(WireError, match="version"):
        decode_access_event(bytes(frame))


@pytest.mark.parametrize("mc", [0.09 + 1e-10, 0.1 + 0.2, -0.0, 5e-324])
def test_wire_bytes_equal_across_packages(mc):
    """Frames and JSON lines are the reference's byte for byte, and each
    package decodes the other's frames to the same fields."""
    ref_ev, ev = regress_cache.AccessEvent(*_fields(mc)), _event(mc)
    frame = encode_access_event(ev)
    assert frame == rfleet.encode_access_event(ref_ev)
    assert access_event_to_json(ev) == rfleet.access_event_to_json(ref_ev)
    assert dataclasses.astuple(rfleet.decode_access_event(frame)) == \
        dataclasses.astuple(ev)
    back = decode_access_event(rfleet.encode_access_event(ref_ev))
    assert back.miss_cost.hex() == mc.hex()
    dollars = {p: mc * (i + 1) for i, p in enumerate(ONLINE_POLICIES)}
    d = WindowDelta("edge1", 3, 2, 812.5, 77, dollars)
    rd = rfleet.WindowDelta("edge1", 3, 2, 812.5, 77, dict(dollars))
    assert encode_window_delta(d) == rfleet.encode_window_delta(rd)
    assert dataclasses.astuple(decode_window_delta(
        rfleet.encode_window_delta(rd))) == dataclasses.astuple(d)


# ---------------------------------------------------------------------------
# watermark + node windows


def test_watermark_tolerates_bounded_skew_rejects_beyond():
    wm = Watermark(max_skew=5.0)
    wm.advance(10.0)
    wm.advance(6.0)
    assert wm.value == 5.0
    assert wm.late == 1
    with pytest.raises(ValueError):
        wm.advance(4.0)


def test_node_emits_contiguous_windows_and_replays_bill_bit_equal():
    store = ObjectStore("s3_internet")
    for i in range(8):
        store.put(f"o{i}", bytes(1000))
    node = FleetNode("edge0", store, 4000, "lru", window_span=10.0,
                     max_skew=2.0)
    for t in [0, 1, 5, 12, 11, 14, 47, 46, 55]:
        node.access(f"o{t % 8}", float(t))
    node.flush()
    wids = [d.window_id for d in node.outbox]
    assert wids == sorted(wids) == list(range(wids[-1] + 1))
    assert [d for d in node.outbox if d.events == 0]
    assert math.fsum(d.events for d in node.outbox) == 9
    assert node.replayed_dollars() == node.cache.meter.dollars


# ---------------------------------------------------------------------------
# gossip


def test_sim_network_deterministic_per_seed():
    def run(pkg, seed):
        net = pkg.SimNetwork(seed, drop=0.3, duplicate=0.3, reorder=0.5,
                             max_delay=2)
        for i in range(50):
            net.send("a", "b", bytes([i]))
        out = [[f[2] for f in net.deliver()] for _ in range(5)]
        return out, net.snapshot()
    assert run(tfleet, 7) == run(tfleet, 7)
    assert run(tfleet, 7) != run(tfleet, 8)
    assert run(tfleet, 7) == run(rfleet, 7)


def test_gossip_merge_idempotent_commutative():
    d1 = WindowDelta("h", 0, 1, 10.0, 5, {"lru": 0.5})
    d2 = WindowDelta("h", 0, 2, 12.0, 6, {"lru": 0.6})
    a, b = GossipState(), GossipState()
    assert a.merge(d1) and a.merge(d2) and not a.merge(d1)
    assert b.merge(d2) and not b.merge(d1)
    assert a.digest() == b.digest()
    assert a.fleet_totals() == b.fleet_totals() == {"lru": 0.6}


# ---------------------------------------------------------------------------
# coordinator


def _delta(host, wid, dollars, seq=1):
    return WindowDelta(host, wid, seq, 0.0, 10, dollars)


def test_quorum_majority_swaps_and_never_double_applies():
    co = FleetCoordinator(3, policy="lru", hysteresis=0.1)
    better = {"lru": 1.0, "lfu": 0.5, "gds": 2.0, "gdsf": 2.0}
    for h in ("a", "b", "c"):
        co.ingest(_delta(h, 0, dict(better)))
    applied = co.poll()
    assert [s.new_policy for s in applied] == ["lfu"]
    assert co.policy == "lfu"
    for h in ("a", "b", "c"):
        co.ingest(_delta(h, 0, dict(better), seq=2))
    assert co.poll() == [] and len(co.swaps) == 1


def test_quorum_waits_for_majority_and_in_order_windows():
    co = FleetCoordinator(4, policy="lru")
    win = {"lru": 1.0, "lfu": 0.1}
    co.ingest(_delta("a", 0, dict(win)))
    co.ingest(_delta("b", 0, dict(win)))
    assert co.poll() == []
    co.ingest(_delta("a", 1, dict(win)))
    co.ingest(_delta("b", 1, dict(win)))
    co.ingest(_delta("c", 1, dict(win)))
    assert co.poll() == []
    co.ingest(_delta("c", 0, dict(win)))
    swaps = co.poll()
    assert co.frontier == 1 and len(swaps) == 1


def test_split_vote_quorum_keeps_incumbent_central_breaks_tie():
    keep = {"lru": 1.0, "lfu": 0.99}
    move = {"lru": 1.0, "lfu": 0.1}
    for mode, expect in (("quorum", "lru"), ("central", "lfu")):
        co = FleetCoordinator(4, policy="lru", mode=mode, quorum=4)
        for h, d in zip("abcd", (keep, keep, move, move)):
            co.ingest(_delta(h, 0, dict(d)))
        co.poll()
        assert co.policy == expect, mode
        if mode == "central":
            assert co.swaps[0].mode == "tiebreak"


def test_zero_weight_windows_keep_incumbent():
    co = FleetCoordinator(2, policy="lru")
    for h in "ab":
        co.ingest(_delta(h, 0, {}))
    co.poll()
    assert co.policy == "lru" and co.frontier == 0 and not co.swaps


# ---------------------------------------------------------------------------
# the 4-node acceptance scenario


@pytest.fixture(scope="module")
def shifted():
    sc = regime_shift_scenario(**SCENARIO)
    fixed = {p: _run_fixed_fleet(sc, p) for p in ONLINE_POLICIES}
    return sc, fixed, _run_governed_fleet(tfleet, sc)


def test_fleet_regime_shift_quorum_swap_post_flip(shifted):
    sc, fixed, fleet = shifted
    flip_window = int(sc.flip_at // FLEET_KW["window_span"])
    assert len(fleet.swaps) == 1
    swap = fleet.swaps[0]
    assert swap.old_policy == "lru"
    assert {n.cache.policy for n in fleet.nodes} == {fleet.policy} \
        == {swap.new_policy}
    assert flip_window <= swap.window_id <= flip_window + 1
    assert swap.new_policy == min(fixed, key=fixed.get)


def test_fleet_dollars_within_10pct_of_best_fixed(shifted):
    sc, fixed, fleet = shifted
    best = min(fixed.values())
    assert fleet.dollars() <= 1.10 * best
    assert fleet.dollars() < max(fixed.values())


def test_fleet_billing_reconciles_bit_for_bit(shifted):
    _sc, _fixed, fleet = shifted
    audits = fleet.audits()
    assert fleet.dollars() == math.fsum(
        a.observed_dollars for a in audits.values())
    for node in fleet.nodes:
        assert node.replayed_dollars() == node.cache.meter.dollars
    totals = fleet.fleet_shadow_totals()
    for node in fleet.nodes:
        assert node.state.fleet_totals() == totals


def test_fleet_under_faults_converges_no_double_swap():
    sc = regime_shift_scenario(**SCENARIO)
    net = SimNetwork(seed=3, drop=0.25, duplicate=0.3, reorder=0.5,
                     max_delay=2)
    fleet = _run_governed_fleet(tfleet, sc, network=net)
    assert net.dropped > 0 and net.duplicated > 0 and net.reordered > 0
    assert fleet.converged()
    wids = [s.window_id for s in fleet.swaps]
    assert len(wids) == len(set(wids))
    assert sorted(fleet.coordinator.decided) == \
        list(range(fleet.coordinator.frontier + 1))
    for node in fleet.nodes:
        assert node.cache.policy_swaps == len(fleet.swaps)
    assert {n.cache.policy for n in fleet.nodes} == {fleet.policy}
    assert len(fleet.swaps) <= 3


def test_fleet_snapshot_shapes(shifted):
    fleet = shifted[2]
    snap = fleet.snapshot()
    assert snap["n_nodes"] == N_NODES
    assert set(snap["nodes"]) == {f"edge{i}" for i in range(N_NODES)}
    assert snap["coordinator"]["frontier"] >= 0
    assert snap["network"]["sent"] > snap["network"]["dropped"]
    assert snap["dollars"] == fleet.dollars()


@pytest.mark.parametrize("faults", [False, True])
def test_governed_fleet_equals_reference(faults):
    """The regime shift through both packages' fleets, with and without a
    faulty network: the same dollars bit for bit, swaps, audits, shadow
    totals and network counters."""

    def net(pkg):
        return pkg.SimNetwork(seed=3, drop=0.25, duplicate=0.3, reorder=0.5,
                              max_delay=2) if faults else None
    ref = _run_governed_fleet(rfleet, rscenario.regime_shift_scenario(
        **SCENARIO), network=net(rfleet))
    port = _run_governed_fleet(tfleet, regime_shift_scenario(**SCENARIO),
                               network=net(tfleet))
    assert port.dollars() == ref.dollars()
    assert [dataclasses.astuple(s) for s in port.swaps] == \
        [dataclasses.astuple(s) for s in ref.swaps]
    assert _audits(port.audits()) == _audits(ref.audits())
    assert port.fleet_shadow_totals() == ref.fleet_shadow_totals()
    assert port.snapshot() == ref.snapshot()


# ---------------------------------------------------------------------------
# tests/test_online.py's regime-shift scenario tests, on the port


def test_regime_shift_governor_within_10pct_of_best_fixed():
    sc = regime_shift_scenario(n_phase=3000, seed=0)
    fixed = {p: run_fixed(sc, p)["dollars"] for p in ONLINE_POLICIES}
    best_policy = min(fixed, key=lambda p: fixed[p])
    m = MetricsRegistry()
    gov_res, gov = run_governed(sc, metrics=m)
    assert gov_res["dollars"] <= 1.10 * fixed[best_policy], (gov_res, fixed)
    assert len(gov_res["swaps"]) >= 1
    store_dollars = gov.cache.store.meter.dollars
    per_consumer = gov.cache.store.consumer_snapshot()
    assert set(per_consumer) == {"governed"}
    assert per_consumer["governed"]["dollars"] == pytest.approx(store_dollars)
    assert m.counter("governor.swaps") == len(gov_res["swaps"])
    assert any(k.startswith("governor.window_dollars.") for k in m.series)
    ref_res, _ = rscenario.run_governed(
        rscenario.regime_shift_scenario(n_phase=3000, seed=0))
    assert gov_res["dollars"] == ref_res["dollars"]
    assert gov_res["swaps"] == ref_res["swaps"]


def test_regime_shift_phase_winners_flip():
    sc = regime_shift_scenario(n_phase=3000, seed=0)
    phase = {}
    for p in ("lru", "gdsf"):
        store = sc.make_store()
        cache = EgressCache(store, sc.capacity_bytes, p, consumer="x")
        ph1 = None
        for t, key in enumerate(sc.keys):
            if t == sc.flip_at:
                store.set_price(sc.price_b)
                ph1 = cache.meter.dollars
            cache.get(key)
        phase[p] = (ph1, cache.meter.dollars - ph1)
    assert phase["lru"][0] < phase["gdsf"][0]
    assert phase["gdsf"][1] < phase["lru"][1]


def test_scenario_equals_reference():
    sc = regime_shift_scenario(**SCENARIO)
    rs = rscenario.regime_shift_scenario(**SCENARIO)
    assert sc.keys == rs.keys and sc.flip_at == rs.flip_at
    assert sc.capacity_bytes == rs.capacity_bytes
    assert dataclasses.asdict(sc.price_b) == dataclasses.asdict(rs.price_b)
    for p in ONLINE_POLICIES:
        assert run_fixed(sc, p) == rscenario.run_fixed(rs, p)


# ---------------------------------------------------------------------------
# the engine's fleet mode


def test_fleet_mode_partitions_prefix_cache():
    """tests/test_serve.py's fleet test on the port: fleet_nodes > 0 shards
    the prefix cache across hash-partitioned hosts with their own meters;
    the audit is per host and the snapshot carries the fleet state."""
    cfg = get_config("phi4-mini-3.8b", smoke=True)
    model = get_model(cfg)
    params = model.init(0, device="cpu")
    engine = ServeEngine(model, params, prefix_cache_bytes=1 << 22,
                         policy="lru", fleet_nodes=3, governor_window=4,
                         device="cpu")
    rng = np.random.default_rng(7)
    hot = [rng.integers(0, cfg.vocab_size, 12).astype(np.int32)
           for _ in range(3)]
    rid = 0
    for _ in range(4):
        engine.serve([Request(rid + i, h, 2) for i, h in enumerate(hot)])
        rid += len(hot)
    fleet = engine.fleet
    assert engine.cache is None and fleet is not None
    assert sum(n.cache.hits + n.cache.misses for n in fleet.nodes) >= 9
    audits = engine.audit()
    assert set(audits) == {n.host for n in fleet.nodes}
    observed = math.fsum(a.observed_dollars for a in audits.values()
                         if a is not None)
    assert fleet.dollars() == observed
    snap = engine.governance_snapshot()
    assert snap["fleet"]["n_nodes"] == 3
    assert snap["fleet"]["dollars"] == fleet.dollars()
    # the fleet state, as JSON, has the checked-in shape
    schemas = pathlib.Path(__file__).parent / "schemas"
    fleet_snap = json.loads(json.dumps(snap["fleet"]))
    obs_schema = json.loads((schemas / "obs.json").read_text())
    for schema in (json.loads((schemas / "fleet.json").read_text()),
                   obs_schema["properties"]["fleet"]):
        assert validate(fleet_snap, schema) == []


def test_fleet_engine_equals_reference_on_moe():
    """One request stream through the reference engine and the port's, both
    in fleet mode on the qwen2-moe smoke config in float32 (blobs of two
    lengths; the cache holds a few): equal per-host audits, fleet dollars,
    meters, snapshots and generated tokens."""
    arch = "qwen2-moe-a2.7b"
    rcfg = dataclasses.replace(ref_config(arch, smoke=True),
                               param_dtype=jnp.float32)
    tcfg = dataclasses.replace(get_config(arch, smoke=True),
                               param_dtype=torch.float32)
    rm, tm = ref_model(rcfg), get_model(tcfg)
    rp = rm.init(jax.random.key(0))
    tp = params_from_numpy(jax.tree.map(np.asarray, rp), "cpu")
    # 12- and 16-token blobs: 2 layers x S x 4 heads x 16 x 4 bytes
    kw = dict(prefix_cache_bytes=3 * 8192, policy="gdsf", fleet_nodes=3,
              governor_window=4)
    ref, port = RefEngine(rm, rp, **kw), ServeEngine(tm, tp, device="cpu",
                                                      **kw)
    rng = np.random.default_rng(13)
    pools = [[rng.integers(0, 256, n).astype(np.int32) for _ in range(4)]
             for n in (12, 16)]
    rid, outs = 0, []
    for _ in range(8):
        rnd = [pool[rng.choice(4, p=[.4, .3, .2, .1])] for pool in pools]
        a = ref.serve([RefRequest(rid + j, p, 3) for j, p in enumerate(rnd)])
        b = port.serve([Request(rid + j, p, 3) for j, p in enumerate(rnd)])
        outs += [(x.output, y.output) for x, y in zip(a, b)]
        rid += len(rnd)
    for want, got in outs:
        np.testing.assert_array_equal(got, want)
    assert port.fleet.dollars() == ref.fleet.dollars() > 0
    assert _audits(port.audit()) == _audits(ref.audit())
    assert port.store.meter.snapshot() == ref.store.meter.snapshot()
    assert port.store.consumer_snapshot() == ref.store.consumer_snapshot()
    misses = sum(n.cache.misses for n in port.fleet.nodes)
    hits = sum(n.cache.hits for n in port.fleet.nodes)
    assert misses > 0 and hits > 0
    assert port.governance_snapshot()["fleet"] == \
        ref.governance_snapshot()["fleet"]
    assert port.governance_snapshot()["metrics"] == \
        ref.governance_snapshot()["metrics"]
