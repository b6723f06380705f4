"""CRD lifecycle (reference ``internal/crd/utils.go`` +
``lib/pkg/apis/.../crd_resource_reservation.go`` / ``crd_demand.go``).

CRD *definitions* here are metadata records in the embedded API server's
registry: group/versions/storage version/annotations.
``ensure_resource_reservations_crd`` reproduces the create-or-upgrade +
wait-until-established flow (utils.go:32-151).  This package serves the
storage versions only (ResourceReservation v1beta2, Demand v1alpha2):
the v1beta1 conversion webhook is not part of it.
"""

from __future__ import annotations

import logging
import time
from typing import Dict, Optional

from .apiserver import APIServer
from .errors import AlreadyExistsError

logger = logging.getLogger(__name__)

RESOURCE_RESERVATION_CRD_NAME = "resourcereservations.sparkscheduler.palantir.com"
DEMAND_CRD_NAME = "demands.scaler.palantir.com"

RR_GROUP = "sparkscheduler.palantir.com"
RR_PLURAL = "resourcereservations"
RR_SHORT_NAME = "rr"
RR_VERSIONS = ({"name": "v1beta2", "served": True, "storage": True},)

DEMAND_GROUP = "scaler.palantir.com"
DEMAND_VERSIONS = ({"name": "v1alpha2", "served": True, "storage": True},)


def resource_reservation_crd_spec(annotations: Optional[Dict[str, str]] = None) -> dict:
    return {
        "group": RR_GROUP,
        "plural": RR_PLURAL,
        "short_names": [RR_SHORT_NAME],
        "versions": [dict(v) for v in RR_VERSIONS],
        "annotations": dict(annotations or {}),
        "established": True,
    }


def demand_crd_spec() -> dict:
    return {
        "group": DEMAND_GROUP,
        "plural": "demands",
        "versions": [dict(v) for v in DEMAND_VERSIONS],
        "annotations": {},
        "established": True,
    }


def _specs_equivalent(existing: dict, desired: dict) -> bool:
    """utils.go's verifyCRD: compare versions + annotations subset."""
    if existing.get("versions") != desired.get("versions"):
        return False
    existing_annotations = existing.get("annotations", {})
    return all(existing_annotations.get(k) == v for k, v in desired.get("annotations", {}).items())


def ensure_resource_reservations_crd(
    api: APIServer,
    annotations: Optional[Dict[str, str]] = None,
    timeout_seconds: float = 60.0,
) -> None:
    """utils.go:98-151: create or upgrade, then wait for Established."""
    desired = resource_reservation_crd_spec(annotations)
    existing = api.get_crd(RESOURCE_RESERVATION_CRD_NAME)
    if existing is None:
        try:
            api.create_crd(RESOURCE_RESERVATION_CRD_NAME, desired)
        except AlreadyExistsError:
            existing = api.get_crd(RESOURCE_RESERVATION_CRD_NAME)
    if existing is not None and not _specs_equivalent(existing, desired):
        logger.info("upgrading resource reservation CRD")
        api.update_crd(RESOURCE_RESERVATION_CRD_NAME, desired)

    deadline = time.monotonic() + timeout_seconds  # real wall time: must not freeze with a virtual clock
    while time.monotonic() < deadline:
        if api.crd_established(RESOURCE_RESERVATION_CRD_NAME):
            return
        time.sleep(0.05)
    api.delete_crd(RESOURCE_RESERVATION_CRD_NAME)
    raise TimeoutError("resource reservation CRD did not become established")
