"""Versioned wire format for fleet-governance messages (DESIGN.md §10).

Two message kinds cross host boundaries:

  * `AccessEvent` — one cache access, exactly as the governance listeners
    see it locally. Hosts append every event to a wire log; replaying a
    decoded log re-accrues the host's bill *bit-for-bit* (the `miss_cost`
    float round-trips exactly — IEEE-754 doubles are framed verbatim, no
    decimal detour), which is what makes cross-host audits reconcilable
    with the per-node `BillingMeter`s.
  * `WindowDelta` — one host's closed event-time window: per-policy shadow
    dollars, the event count, and the host watermark at close. This is the
    gossip payload; fleet-wide per-policy totals are sums of deltas.

Framing is deliberately boring: 2-byte magic, u8 version, u8 kind, a
fixed-layout payload (strings are u16-length-prefixed UTF-8, floats are
little-endian f64), and a CRC-32 trailer over everything before it. Any
magic/version/kind/checksum/layout violation raises `WireError` — a
corrupt frame is rejected, never half-parsed (property-tested in
tests/test_fleet_property.py). A JSON codec for `AccessEvent` is provided
for logs meant to be read by humans or non-Python consumers; it carries
`miss_cost`/`event_time` both as plain floats (readable) and as C99 hex
floats (`float.hex()`, bit-exact), and decoding prefers the hex form.
"""
from __future__ import annotations

import binascii
import dataclasses
import json
import struct

from repro_torch.egress.cache import ONLINE_POLICIES, AccessEvent

__all__ = [
    "WIRE_VERSION", "WireError", "WindowDelta",
    "encode_access_event", "decode_access_event",
    "encode_window_delta", "decode_window_delta", "decode",
    "access_event_to_json", "access_event_from_json",
]

WIRE_VERSION = 1
_MAGIC = b"FG"                       # "fleet governance"
KIND_ACCESS_EVENT = 0
KIND_WINDOW_DELTA = 1
_KINDS = (KIND_ACCESS_EVENT, KIND_WINDOW_DELTA)


class WireError(ValueError):
    """Raised for any malformed frame: bad magic, unsupported version,
    unknown kind, checksum mismatch, or a payload layout violation."""


@dataclasses.dataclass(frozen=True)
class WindowDelta:
    """One host's closed event-time window of shadow-dollar evidence.

    `seq` is the host's monotone emission counter: gossip merges keep the
    highest seq per (host, window_id), so duplicated or reordered delivery
    can never regress a peer's view (see gossip.GossipState).
    """
    host: str
    window_id: int
    seq: int
    watermark: float          # host watermark when the window closed
    events: int               # accesses folded into this window
    dollars: dict             # policy -> windowed counterfactual dollars


# ---------------------------------------------------------------------------
# framing
# ---------------------------------------------------------------------------

def _frame(kind: int, payload: bytes) -> bytes:
    body = _MAGIC + struct.pack("<BB", WIRE_VERSION, kind) + payload
    return body + struct.pack("<I", binascii.crc32(body))


def _unframe(buf: bytes, expect_kind: int) -> bytes:
    if len(buf) < 8:
        raise WireError(f"frame truncated: {len(buf)} bytes")
    if buf[:2] != _MAGIC:
        raise WireError(f"bad magic {buf[:2]!r}")
    version, kind = struct.unpack_from("<BB", buf, 2)
    if version != WIRE_VERSION:
        raise WireError(f"unsupported wire version {version}")
    if kind not in _KINDS:
        raise WireError(f"unknown message kind {kind}")
    (crc,) = struct.unpack_from("<I", buf, len(buf) - 4)
    if binascii.crc32(buf[:-4]) != crc:
        raise WireError("checksum mismatch")
    if kind != expect_kind:
        raise WireError(f"expected kind {expect_kind}, got {kind}")
    return buf[4:-4]


def _peek_kind(buf: bytes) -> int:
    if len(buf) < 4 or buf[:2] != _MAGIC:
        raise WireError("bad or truncated frame header")
    return buf[3]


def _policy_index(policy: str) -> int:
    try:
        return ONLINE_POLICIES.index(policy)
    except ValueError:
        raise WireError(f"unknown policy {policy!r}") from None


# ---------------------------------------------------------------------------
# AccessEvent
# ---------------------------------------------------------------------------

_EV_FIXED = struct.Struct("<BBQQdd")   # policy, hit, nbytes, clock, mc, t


def encode_access_event(ev: AccessEvent) -> bytes:
    key = ev.key.encode("utf-8")
    if len(key) > 0xFFFF:
        raise WireError(f"key too long for wire format: {len(key)} bytes")
    payload = (struct.pack("<H", len(key)) + key
               + _EV_FIXED.pack(_policy_index(ev.policy), 1 if ev.hit else 0,
                                ev.nbytes, ev.clock, ev.miss_cost,
                                ev.event_time))
    return _frame(KIND_ACCESS_EVENT, payload)


def decode_access_event(buf: bytes) -> AccessEvent:
    p = _unframe(buf, KIND_ACCESS_EVENT)
    try:
        (klen,) = struct.unpack_from("<H", p, 0)
        key = p[2:2 + klen].decode("utf-8")
        if len(p) != 2 + klen + _EV_FIXED.size:
            raise WireError(f"payload length mismatch: {len(p)} bytes")
        pol, hit, nbytes, clock, mc, t = _EV_FIXED.unpack_from(p, 2 + klen)
    except (struct.error, UnicodeDecodeError) as e:
        raise WireError(f"malformed AccessEvent payload: {e}") from None
    if pol >= len(ONLINE_POLICIES) or hit > 1:
        raise WireError(f"field out of range: policy={pol} hit={hit}")
    return AccessEvent(key, nbytes, bool(hit), mc, ONLINE_POLICIES[pol],
                       clock, t)


def access_event_to_json(ev: AccessEvent) -> str:
    return json.dumps(dict(
        v=WIRE_VERSION, kind="access_event", key=ev.key, nbytes=ev.nbytes,
        hit=ev.hit, policy=ev.policy, clock=ev.clock,
        miss_cost=ev.miss_cost, miss_cost_hex=float(ev.miss_cost).hex(),
        event_time=ev.event_time,
        event_time_hex=float(ev.event_time).hex()), sort_keys=True)


def access_event_from_json(line: str) -> AccessEvent:
    try:
        d = json.loads(line)
    except json.JSONDecodeError as e:
        raise WireError(f"malformed JSON frame: {e}") from None
    if d.get("v") != WIRE_VERSION:
        raise WireError(f"unsupported wire version {d.get('v')}")
    if d.get("kind") != "access_event":
        raise WireError(f"unexpected kind {d.get('kind')!r}")
    if d.get("policy") not in ONLINE_POLICIES:
        raise WireError(f"unknown policy {d.get('policy')!r}")
    try:
        # the hex fields are authoritative (bit-exact); plain floats are
        # for human eyes and lossy-JSON consumers
        mc = float.fromhex(d["miss_cost_hex"]) if "miss_cost_hex" in d \
            else float(d["miss_cost"])
        t = float.fromhex(d["event_time_hex"]) if "event_time_hex" in d \
            else float(d["event_time"])
        return AccessEvent(str(d["key"]), int(d["nbytes"]), bool(d["hit"]),
                           mc, d["policy"], int(d["clock"]), t)
    except (KeyError, ValueError, TypeError) as e:
        raise WireError(f"malformed AccessEvent JSON: {e}") from None


# ---------------------------------------------------------------------------
# WindowDelta
# ---------------------------------------------------------------------------

_WD_FIXED = struct.Struct("<QQdIB")    # window_id, seq, watermark, events, n


def encode_window_delta(d: WindowDelta) -> bytes:
    host = d.host.encode("utf-8")
    if len(host) > 0xFFFF:
        raise WireError(f"host name too long: {len(host)} bytes")
    parts = [struct.pack("<H", len(host)), host,
             _WD_FIXED.pack(d.window_id, d.seq, d.watermark, d.events,
                            len(d.dollars))]
    for policy in sorted(d.dollars, key=_policy_index):
        parts.append(struct.pack("<Bd", _policy_index(policy),
                                 d.dollars[policy]))
    return _frame(KIND_WINDOW_DELTA, b"".join(parts))


def decode_window_delta(buf: bytes) -> WindowDelta:
    p = _unframe(buf, KIND_WINDOW_DELTA)
    try:
        (hlen,) = struct.unpack_from("<H", p, 0)
        host = p[2:2 + hlen].decode("utf-8")
        wid, seq, wm, events, n = _WD_FIXED.unpack_from(p, 2 + hlen)
        off = 2 + hlen + _WD_FIXED.size
        if len(p) != off + n * 9:
            raise WireError(f"payload length mismatch: {len(p)} bytes")
        dollars = {}
        for _ in range(n):
            pol, dv = struct.unpack_from("<Bd", p, off)
            off += 9
            if pol >= len(ONLINE_POLICIES):
                raise WireError(f"policy index out of range: {pol}")
            dollars[ONLINE_POLICIES[pol]] = dv
    except (struct.error, UnicodeDecodeError) as e:
        raise WireError(f"malformed WindowDelta payload: {e}") from None
    return WindowDelta(host, wid, seq, wm, events, dollars)


def decode(buf: bytes):
    """Decode either message kind (gossip receivers dispatch here)."""
    if _peek_kind(buf) == KIND_ACCESS_EVENT:
        return decode_access_event(buf)
    return decode_window_delta(buf)
