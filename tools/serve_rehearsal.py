"""Predict the bill of `chip_smoke.py`'s serve streams from the host alone.

    python3 tools/serve_rehearsal.py [--seed 1] [ARCH ...]

For each architecture (at its full-size config) this draws the serve
stream `chip_smoke.py` draws, derives the keys its engine touches
(`chip_smoke.engine_touches`) and the blob of each prompt
(`chip_smoke.blob_bytes`), and replays them through the engine's cache,
governor and auditor with no model (`chip_smoke.host_replay`). It prints
one JSON line an architecture: touches, GETs, hits, misses, dollars, the
audit's OPT and the cache events. Needs no GPU: the bill depends only on
the keys and the blobs' lengths.
"""
from __future__ import annotations

import argparse
import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke  # noqa: E402

# each architecture's prefix cache in chip_smoke.py
CAPACITY = {
    "phi4-mini-3.8b": lambda cfg: 4 * chip_smoke.blob_bytes(
        cfg, chip_smoke.SERVE_PROMPT),
    "qwen2-moe-a2.7b": lambda cfg: chip_smoke.MOE_CACHE_BYTES,
    "recurrentgemma-9b": lambda cfg: 4 * chip_smoke.blob_bytes(
        cfg, chip_smoke.SERVE_PROMPT),
    "xlstm-125m": lambda cfg: 4 * chip_smoke.blob_bytes(
        cfg, chip_smoke.SERVE_PROMPT),
}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=1)
    ap.add_argument("archs", nargs="*", default=list(CAPACITY))
    args = ap.parse_args()
    for arch in args.archs:
        cfg = chip_smoke.get_config(arch)
        capacity = CAPACITY[arch](cfg)
        r = chip_smoke.rehearse(cfg, args.seed, capacity)
        audit = r.pop("audit")
        r.pop("keys")
        print(json.dumps(dict(
            arch=arch, capacity=capacity,
            blob_bytes={"pool": chip_smoke.blob_bytes(
                cfg, chip_smoke.SERVE_PROMPT), "long": chip_smoke.blob_bytes(
                cfg, chip_smoke.SERVE_LONG)},
            **r, opt_dollars=[audit.opt_dollars_lower,
                              audit.opt_dollars_upper])), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
