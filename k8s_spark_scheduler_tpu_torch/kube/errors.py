"""k8s-style API error model (status reasons the scheduler reacts to).

The reference distinguishes Conflict (409 → refresh resourceVersion and
retry inline, async.go:111-120), NotFound, AlreadyExists, and the
namespace-terminating Forbidden/NotFound shapes (async.go:160-163).
"""

from __future__ import annotations


class APIError(Exception):
    reason = "Unknown"

    def __init__(self, message: str = ""):
        super().__init__(message or self.reason)
        self.message = message or self.reason


class ConflictError(APIError):
    reason = "Conflict"


class NotFoundError(APIError):
    reason = "NotFound"


class AlreadyExistsError(APIError):
    reason = "AlreadyExists"


class ForbiddenError(APIError):
    reason = "Forbidden"


class NamespaceTerminatingError(ForbiddenError):
    """Create refused because the namespace is being deleted."""

    def __init__(self, namespace: str):
        super().__init__(
            f"unable to create new content in namespace {namespace} because it is being terminated"
        )
        self.namespace = namespace


def is_namespace_terminating(err: Exception) -> bool:
    """async.go:160-163."""
    if isinstance(err, NamespaceTerminatingError):
        return True
    if isinstance(err, ForbiddenError) and "because it is being terminated" in str(err):
        return True
    if isinstance(err, NotFoundError) and "namespaces" in str(err) and "not found" in str(err):
        return True
    return False
