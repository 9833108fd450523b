# Billing-faithful egress layer: the cloud store simulator (eq. 1 metering,
# per-consumer attribution) and the deployable dollar-aware cache with its
# offline-exact audit. The online governance layer (repro.online) subscribes
# to EgressCache's AccessEvent stream from above.
from .store import BillingMeter, ObjectStore
from .cache import (ONLINE_POLICIES, AccessEvent, AdmissionController,
                    AuditReport, EgressCache)

__all__ = [
    "BillingMeter", "ObjectStore", "ONLINE_POLICIES", "AccessEvent",
    "AdmissionController", "AuditReport", "EgressCache",
]
