"""Client-side rate limiting (reference cmd/clients.go:53-54: the kube
clientsets are built with configured QPS + Burst).

A token bucket: capacity=burst, refill=qps tokens/sec; acquire() blocks
until a token is available — or, with a timeout, only until the caller's
budget runs out.  qps<=0 disables limiting (the reference leaves the
client defaults; we treat unset as unlimited).
"""

from __future__ import annotations

import threading
import time
from typing import Optional



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


class RateLimitedClient:
    """Wraps a TypedClient-shaped client with a shared token bucket."""

    def __init__(self, delegate, bucket: TokenBucket):
        self._delegate = delegate
        self._bucket = bucket

    def _acquire(self) -> None:
        self._bucket.acquire()

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
