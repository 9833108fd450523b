# Fleet governance over many edge hosts (DESIGN.md §10): one origin store,
# N FleetNodes (live cache + shadow panel + event-time watermark windows),
# a fault-injectable gossip fabric exchanging WindowDelta evidence, and a
# coordinator applying quorum dollar-policy swaps fleet-wide.
#   wire        — versioned binary/JSON framing; dollars round-trip bit-equal
#   node        — per-host cache + shadow windows + wire log
#   gossip      — SimNetwork (drop/duplicate/reorder/delay) + GossipState
#   coordinator — quorum votes, centralized tiebreak, the Fleet facade
# Layering: fleet sits above egress/online and publishes to obs duck-typed
# (events/metrics arrive as plain objects; repro.obs is never imported).
from .wire import (WIRE_VERSION, WindowDelta, WireError,
                   access_event_from_json, access_event_to_json, decode,
                   decode_access_event, decode_window_delta,
                   encode_access_event, encode_window_delta)
from .gossip import GossipState, SimNetwork
from .node import FleetNode
from .coordinator import Fleet, FleetCoordinator, FleetSwap, hash_partition

__all__ = [
    "WIRE_VERSION", "WireError", "WindowDelta",
    "encode_access_event", "decode_access_event",
    "encode_window_delta", "decode_window_delta", "decode",
    "access_event_to_json", "access_event_from_json",
    "SimNetwork", "GossipState", "FleetNode",
    "Fleet", "FleetCoordinator", "FleetSwap", "hash_partition",
]
