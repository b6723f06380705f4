"""Client-side rate limiting (reference cmd/clients.go:53-54: the kube
clientsets are built with configured QPS + Burst).

A token bucket: capacity=burst, refill=qps tokens/sec; acquire() blocks
until a token is available — or, with a timeout, only until the caller's
budget runs out, so a rate-limited write can respect the request
deadline propagated by the resilience layer instead of blocking a
worker (or the request path) indefinitely.  qps<=0 disables limiting (the reference leaves the
client defaults; we treat unset as unlimited).
"""

from __future__ import annotations

import threading
import time
from typing import Optional

from .errors import APIError


class RateLimitTimeoutError(APIError):
    """Gave up waiting for a rate-limit token (deadline/timeout).  A
    retriable client-side condition — nothing reached the server."""

    reason = "RateLimitTimeout"


class TokenBucket:
    def __init__(self, qps: float, burst: int):
        self.qps = qps
        self.burst = max(burst, 1)
        self._tokens = float(self.burst)
        self._last = time.monotonic()
        self._lock = threading.Lock()

    def acquire(self, timeout: Optional[float] = None) -> bool:
        """Take one token.  Blocks until available; with ``timeout``
        (seconds) gives up and returns False once waiting any longer
        would exceed it.  ``timeout <= 0`` means no budget left: only an
        immediately-available token succeeds."""
        if self.qps <= 0:
            return True
        deadline = time.monotonic() + timeout if timeout is not None else None
        while True:
            with self._lock:
                now = time.monotonic()
                self._tokens = min(
                    self.burst, self._tokens + (now - self._last) * self.qps
                )
                self._last = now
                if self._tokens >= 1.0:
                    self._tokens -= 1.0
                    return True
                wait = (1.0 - self._tokens) / self.qps
            if deadline is not None and time.monotonic() + wait > deadline:
                return False
            time.sleep(wait)


def acquire_within_deadline(bucket: TokenBucket) -> None:
    """Take one token, waiting at most the propagated request deadline
    (resilience/deadline.py) when one is bound.  Raises
    :class:`RateLimitTimeoutError` — retriable, nothing was sent — when
    the wait cannot fit, instead of blocking past the caller's timeout."""
    from ..resilience import deadline as req_deadline

    remaining = req_deadline.remaining()
    if not bucket.acquire(timeout=remaining):
        raise RateLimitTimeoutError(
            f"rate-limit token wait exceeds the request deadline "
            f"({remaining:.3f}s remaining)"
        )


class RateLimitedClient:
    """Wraps a TypedClient-shaped client with a shared token bucket;
    token waits are deadline-bounded (see acquire_within_deadline)."""

    def __init__(self, delegate, bucket: TokenBucket):
        self._delegate = delegate
        self._bucket = bucket

    def _acquire(self) -> None:
        acquire_within_deadline(self._bucket)

    def create(self, obj):
        self._acquire()
        return self._delegate.create(obj)

    def update(self, obj):
        self._acquire()
        return self._delegate.update(obj)

    def delete(self, namespace: str, name: str):
        self._acquire()
        return self._delegate.delete(namespace, name)

    def get(self, namespace: str, name: str):
        self._acquire()
        return self._delegate.get(namespace, name)
