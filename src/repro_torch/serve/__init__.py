# Serving layer: continuous-batching engine with an egress-billed prefix
# cache, optionally governed by the online dollar-governor.
from .engine import Request, ServeEngine

__all__ = ["Request", "ServeEngine"]
