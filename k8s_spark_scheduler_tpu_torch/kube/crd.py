"""CRD lifecycle (reference ``internal/crd/utils.go`` +
``lib/pkg/apis/.../crd_resource_reservation.go`` / ``crd_demand.go``).

CRD *definitions* here are metadata records in the embedded API server's
registry: group/versions/storage version/annotations/conversion
strategy.  ``ensure_resource_reservations_crd`` reproduces the
create-or-upgrade + wait-until-established flow (utils.go:32-151).
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
# v1beta2 is storage/hub; v1beta1 is served for back-compat
# (crd_resource_reservation.go, conversion strategy webhook)
RR_VERSIONS = ({"name": "v1beta2", "served": True, "storage": True},
               {"name": "v1beta1", "served": True, "storage": False})

DEMAND_GROUP = "scaler.palantir.com"
DEMAND_VERSIONS = ({"name": "v1alpha2", "served": True, "storage": True},
                   {"name": "v1alpha1", "served": True, "storage": False})


def resource_reservation_crd_spec(
    annotations: Optional[Dict[str, str]] = None,
    conversion_webhook=None,
) -> dict:
    """conversion_webhook (config.ConversionWebhookConfig) fills the
    webhook clientConfig the apiserver dials for v1beta1↔v1beta2
    conversion — HTTPS-only, so the caBundle is mandatory there
    (ref conversionwebhook/resource_reservation.go:44-98)."""
    conversion: dict = {"strategy": "Webhook"}
    if conversion_webhook is not None:
        client_config: dict = {
            "service": {
                "namespace": conversion_webhook.service_namespace,
                "name": conversion_webhook.service_name,
                "port": conversion_webhook.service_port,
                "path": conversion_webhook.path,
            }
        }
        if conversion_webhook.ca_bundle_file:
            import base64

            with open(conversion_webhook.ca_bundle_file, "rb") as f:
                client_config["caBundle"] = base64.b64encode(f.read()).decode()
        conversion["webhook"] = {
            "clientConfig": client_config,
            "conversionReviewVersions": ["v1"],
        }
    return {
        "group": RR_GROUP,
        "plural": RR_PLURAL,
        "short_names": [RR_SHORT_NAME],
        "versions": [dict(v) for v in RR_VERSIONS],
        "annotations": dict(annotations or {}),
        "conversion": conversion,
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


def _specs_equivalent(existing: dict, desired: dict, check_conversion: bool) -> bool:
    """utils.go's verifyCRD: compare versions + annotations subset, and
    — only when this process actually manages the webhook identity —
    the conversion stanza (a caBundle/service change must roll out).
    Without a configured webhook we must NOT force our bare
    {strategy: Webhook} over an existing CRD's valid clientConfig: a
    real apiserver rejects Webhook strategy without a webhook block."""
    if existing.get("versions") != desired.get("versions"):
        return False
    if check_conversion and existing.get("conversion") != desired.get("conversion"):
        return False
    existing_annotations = existing.get("annotations", {})
    return all(existing_annotations.get(k) == v for k, v in desired.get("annotations", {}).items())


def ensure_resource_reservations_crd(
    api: APIServer,
    annotations: Optional[Dict[str, str]] = None,
    timeout_seconds: float = 60.0,
    conversion_webhook=None,
) -> None:
    """utils.go:98-151: create or upgrade, then wait for Established."""
    desired = resource_reservation_crd_spec(annotations, conversion_webhook)
    existing = api.get_crd(RESOURCE_RESERVATION_CRD_NAME)
    if existing is None:
        try:
            api.create_crd(RESOURCE_RESERVATION_CRD_NAME, desired)
        except AlreadyExistsError:
            existing = api.get_crd(RESOURCE_RESERVATION_CRD_NAME)
    if existing is not None and not _specs_equivalent(
        existing, desired, check_conversion=conversion_webhook is not None
    ):
        logger.info("upgrading resource reservation CRD")
        api.update_crd(RESOURCE_RESERVATION_CRD_NAME, desired)

    deadline = time.monotonic() + timeout_seconds  # real wall time: must not freeze with a virtual clock
    while time.monotonic() < deadline:
        if api.crd_established(RESOURCE_RESERVATION_CRD_NAME):
            return
        time.sleep(0.05)
    api.delete_crd(RESOURCE_RESERVATION_CRD_NAME)
    raise TimeoutError("resource reservation CRD did not become established")
