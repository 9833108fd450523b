"""Property tests of the port's fleet wire format and gossip convergence:
tests/test_fleet_property.py on `repro_torch.fleet`, with every frame and
JSON line also held byte for byte against the reference's encoding of the
same fields, and each package decoding the other's frames.

Guarded with `pytest.importorskip`, as the reference's file is.
"""
import binascii
import dataclasses
import math
import struct

import pytest

pytest.importorskip("hypothesis")
from hypothesis import given, settings, strategies as st  # noqa: E402

import repro.egress.cache as regress_cache  # noqa: E402
import repro.fleet as rfleet  # noqa: E402
from repro_torch.egress.cache import ONLINE_POLICIES, AccessEvent  # noqa: E402
from repro_torch.fleet import (GossipState, SimNetwork,  # noqa: E402
                               WindowDelta, WireError,
                               access_event_from_json, access_event_to_json,
                               decode_access_event, decode_window_delta,
                               encode_access_event, encode_window_delta)

finite_f64 = st.floats(allow_nan=False, allow_infinity=False, width=64)
keys = st.text(min_size=1, max_size=40)

events = st.builds(
    AccessEvent,
    key=keys,
    nbytes=st.integers(0, 2**48),
    hit=st.booleans(),
    miss_cost=finite_f64,
    policy=st.sampled_from(ONLINE_POLICIES),
    clock=st.integers(0, 2**48),
    event_time=finite_f64,
)

deltas = st.builds(
    WindowDelta,
    host=keys,
    window_id=st.integers(0, 2**32),
    seq=st.integers(0, 2**32),
    watermark=finite_f64,
    events=st.integers(0, 2**31),
    dollars=st.dictionaries(st.sampled_from(ONLINE_POLICIES), finite_f64,
                            max_size=len(ONLINE_POLICIES)),
)


def _ref_event(ev):
    return regress_cache.AccessEvent(*dataclasses.astuple(ev))


def _ref_delta(d):
    return rfleet.WindowDelta(d.host, d.window_id, d.seq, d.watermark,
                              d.events, dict(d.dollars))


@settings(max_examples=100, deadline=None)
@given(events)
def test_access_event_binary_round_trip(ev):
    frame = encode_access_event(ev)
    back = decode_access_event(frame)
    assert back == ev
    assert back.miss_cost.hex() == ev.miss_cost.hex()       # bit-equal
    assert back.event_time.hex() == ev.event_time.hex()
    assert frame == rfleet.encode_access_event(_ref_event(ev))
    assert dataclasses.astuple(rfleet.decode_access_event(frame)) == \
        dataclasses.astuple(ev)


@settings(max_examples=100, deadline=None)
@given(events)
def test_access_event_json_round_trip(ev):
    line = access_event_to_json(ev)
    back = access_event_from_json(line)
    assert back == ev
    assert back.miss_cost.hex() == ev.miss_cost.hex()
    assert line == rfleet.access_event_to_json(_ref_event(ev))


@settings(max_examples=100, deadline=None)
@given(deltas)
def test_window_delta_round_trip(d):
    frame = encode_window_delta(d)
    back = decode_window_delta(frame)
    assert back == d
    for p, v in d.dollars.items():
        assert back.dollars[p].hex() == v.hex()
    assert frame == rfleet.encode_window_delta(_ref_delta(d))
    assert dataclasses.astuple(decode_window_delta(
        rfleet.encode_window_delta(_ref_delta(d)))) == dataclasses.astuple(d)


@settings(max_examples=100, deadline=None)
@given(events, st.data())
def test_single_byte_corruption_always_rejected(ev, data):
    frame = bytearray(encode_access_event(ev))
    pos = data.draw(st.integers(0, len(frame) - 1))
    mask = data.draw(st.integers(1, 255))
    frame[pos] ^= mask
    with pytest.raises(WireError):
        decode_access_event(bytes(frame))


@settings(max_examples=50, deadline=None)
@given(events, st.integers(1, 254))
def test_version_bump_rejected_even_with_valid_crc(ev, bump):
    frame = bytearray(encode_access_event(ev))
    frame[2] = (frame[2] + bump) % 256
    frame[-4:] = struct.pack("<I", binascii.crc32(bytes(frame[:-4])))
    with pytest.raises(WireError):
        decode_access_event(bytes(frame))


@settings(max_examples=50, deadline=None)
@given(deltas)
def test_kind_mismatch_rejected(d):
    with pytest.raises(WireError):
        decode_access_event(encode_window_delta(d))


@pytest.mark.parametrize("seed", range(10))
def test_gossip_converges_under_faults_deterministic(seed):
    """Anti-entropy over a faulty switch reaches the unique fixpoint: the
    union of everyone's deltas, identical dollars at every participant."""
    hosts = [f"h{i}" for i in range(4)]
    states = {h: GossipState() for h in hosts}
    for i, h in enumerate(hosts):
        for w in range(3):
            states[h].merge(WindowDelta(h, w, w + 1, float(w), 1,
                                        {"lru": 0.25 * (i + 1) + w}))
    net = SimNetwork(seed, drop=0.3, duplicate=0.3, reorder=0.5, max_delay=2)
    rounds = 0
    while len({s.digest() for s in states.values()}) > 1:
        rounds += 1
        assert rounds <= 50, "gossip failed to converge"
        for h in hosts:
            frames = [encode_window_delta(d)
                      for d in states[h].deltas.values()]
            for peer in hosts:
                if peer != h:
                    for f in frames:
                        net.send(h, peer, f)
        for dst, _src, frame in net.deliver():
            states[dst].merge(decode_window_delta(frame))
    totals = [s.fleet_totals() for s in states.values()]
    assert all(t == totals[0] for t in totals)
    assert len(states[hosts[0]].deltas) == len(hosts) * 3
    expect = math.fsum(0.25 * (i + 1) + w
                       for i in range(4) for w in range(3))
    assert totals[0]["lru"] == expect
