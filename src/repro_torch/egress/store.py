"""Billing-faithful cloud object store simulator.

Every GET is billed `f + s_i * e` per the paper's eq. (1). The framework's
data pipeline, checkpoint restore path, and serving prefix cache all fetch
through this interface, so training/serving runs produce real billing
traces that the offline reference (core/) can audit.

Billing is attributed twice: once on the store-wide `meter`, and once on a
per-consumer meter (`meter_for(name)`) when the GET names its consumer —
so a cache's audit can score exactly the dollars *it* caused, not traffic
from other consumers sharing the store (DESIGN.md §8). Dollars accrue at
the price in effect when each GET happens, so `set_price` (a mid-stream
cloud repricing) never rewrites history.

Observability (DESIGN.md §9): an attached tracer (duck-typed — this layer
never imports `repro.obs`) gets one `store.get` span per billed GET,
carrying the exact dollars the meter accrued for it, the byte count, and
the size-vs-s* regime tag; summing span dollars per consumer reproduces
that consumer's meter total.
"""
from __future__ import annotations

import dataclasses
import threading
from typing import Callable, Optional

from repro_torch.core.pricing import PRICE_VECTORS, PriceVector

__all__ = ["BillingMeter", "ObjectStore"]


@dataclasses.dataclass
class BillingMeter:
    price: PriceVector
    gets: int = 0
    puts: int = 0
    bytes_egressed: float = 0.0
    dollars: float = 0.0  # accrued at the price in effect at each GET

    def record_get(self, nbytes: float):
        self.gets += 1
        self.bytes_egressed += nbytes
        self.dollars += self.price.miss_cost_scalar(nbytes)

    def snapshot(self) -> dict:
        return dict(gets=self.gets, puts=self.puts,
                    bytes_egressed=self.bytes_egressed, dollars=self.dollars,
                    price=self.price.name)


class ObjectStore:
    """In-memory stand-in for S3/GCS/Azure blob, with per-GET billing.

    Objects may be stored eagerly (`put`) or lazily via a generator
    (`register_lazy`) so multi-GB synthetic datasets don't occupy RAM.
    """

    def __init__(self, price: PriceVector | str = "s3_internet",
                 tracer=None):
        if isinstance(price, str):
            price = PRICE_VECTORS[price]
        self.meter = BillingMeter(price)
        self.tracer = tracer    # duck-typed: .span(name, cat=..., **attrs)
        self._consumer_meters: dict[str, BillingMeter] = {}
        self._data: dict[str, bytes] = {}
        self._lazy: dict[str, tuple[int, Callable[[], bytes]]] = {}
        self._lock = threading.Lock()

    def set_tracer(self, tracer) -> None:
        """Attach/detach the span tracer (None or falsy disables)."""
        self.tracer = tracer

    # ---- pricing ----------------------------------------------------------
    @property
    def price(self) -> PriceVector:
        return self.meter.price

    def set_price(self, price: PriceVector | str) -> None:
        """Swap the billing vector mid-stream (cloud repricing). Already-
        accrued dollars are untouched; future GETs bill at the new rates."""
        if isinstance(price, str):
            price = PRICE_VECTORS[price]
        with self._lock:
            self.meter.price = price
            for m in self._consumer_meters.values():
                m.price = price

    # ---- per-consumer attribution -----------------------------------------
    def meter_for(self, consumer: str) -> BillingMeter:
        """The meter that bills only GETs naming `consumer`."""
        with self._lock:
            m = self._consumer_meters.get(consumer)
            if m is None:
                m = self._consumer_meters[consumer] = BillingMeter(self.meter.price)
            return m

    def consumer_snapshot(self) -> dict:
        """Per-consumer billing breakdown (dollars sum to meter.dollars when
        every GET names a consumer)."""
        return {name: m.snapshot() for name, m in self._consumer_meters.items()}

    # ---- producer side -----------------------------------------------------
    def put(self, key: str, data: bytes) -> None:
        with self._lock:
            self._data[key] = data
            self.meter.puts += 1

    def register_lazy(self, key: str, nbytes: int,
                      producer: Callable[[], bytes]) -> None:
        with self._lock:
            self._lazy[key] = (nbytes, producer)

    # ---- consumer side (billed) ---------------------------------------------
    def get(self, key: str, consumer: Optional[str] = None) -> bytes:
        t = self.tracer
        if not t:
            return self._get_billed(key, consumer)
        with t.span("store.get", cat="store", key=key,
                    consumer=consumer or "") as sp:
            data = self._get_billed(key, consumer)
            nbytes = len(data)
            price = self.meter.price
            # the exact float the meter accrued for this GET
            sp.set(bytes=nbytes,
                   dollars=price.miss_cost_scalar(nbytes),
                   regime=("fee_dominated"
                           if nbytes <= price.crossover_bytes
                           else "egress_dominated"))
            return data

    def _get_billed(self, key: str, consumer: Optional[str]) -> bytes:
        with self._lock:
            if key in self._data:
                data = self._data[key]
            elif key in self._lazy:
                data = self._lazy[key][1]()
            else:
                raise KeyError(key)
            self.meter.record_get(len(data))
            if consumer is not None:
                m = self._consumer_meters.get(consumer)
                if m is None:
                    m = self._consumer_meters[consumer] = \
                        BillingMeter(self.meter.price)
                m.record_get(len(data))
            return data

    def size_of(self, key: str) -> int:
        if key in self._data:
            return len(self._data[key])
        if key in self._lazy:
            return self._lazy[key][0]
        raise KeyError(key)

    def contains(self, key: str) -> bool:
        return key in self._data or key in self._lazy

    def keys(self):
        return list(self._data) + list(self._lazy)
