"""CLI entry point (reference main.go + cmd/root.go + cmd/server.go).

    python -m k8s_spark_scheduler_tpu_torch.server [--port P] [--config FILE] [--device {cuda,cpu}]
    python -m k8s_spark_scheduler_tpu_torch.server --version

``--config`` takes a JSON file in the reference's install.yml shape
(config/config.go keys).  The server runs against the embedded API
server.  ``--device`` is where the tpu-batch* queue solvers run:
``cuda`` (the default) raises on a host without CUDA, ``cpu`` runs the
kernels' plain PyTorch versions.
"""

from __future__ import annotations

import argparse
import faulthandler
import json
import logging
import os
import signal
import sys
import threading

from .. import __version__
from ..config import Install
from ..kube.apiserver import APIServer
from .http import ExtenderHTTPServer
from .wiring import init_server_with_clients


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(prog="tpu-gang-scheduler-torch")
    parser.add_argument("--version", action="store_true", help="print version and exit")
    parser.add_argument("--port", type=int, default=8080)
    parser.add_argument("--host", type=str, default="", help="bind address (default: all interfaces)")
    parser.add_argument("--config", type=str, default=None, help="install config JSON file")
    parser.add_argument(
        "--device",
        choices=("cuda", "cpu"),
        default="cuda",
        help="where the tpu-batch* queue solvers run (default: cuda)",
    )
    args = parser.parse_args(argv)

    if args.version:
        print(__version__)
        return 0

    class _JsonFormatter(logging.Formatter):
        def format(self, record):
            return json.dumps(
                {
                    "time": self.formatTime(record),
                    "level": record.levelname,
                    "logger": record.name,
                    "message": record.getMessage(),
                }
            )

    handler = logging.StreamHandler()
    handler.setFormatter(_JsonFormatter())
    logging.basicConfig(level=logging.INFO, handlers=[handler])
    # stacktrace-on-signal, as the reference registers in main.go:24-27
    faulthandler.register(signal.SIGUSR1, all_threads=True)

    # Python-level handlers (run in the main thread no matter which
    # thread receives the signal) so SIGTERM reliably takes the
    # graceful-stop path; a SECOND signal restores the default
    # disposition and re-raises, so a wedged shutdown can still be
    # terminated without SIGKILL
    stop_event = threading.Event()

    def _on_signal(signum, frame):
        if stop_event.is_set():
            signal.signal(signum, signal.SIG_DFL)
            os.kill(os.getpid(), signum)
            return
        stop_event.set()

    signal.signal(signal.SIGINT, _on_signal)
    signal.signal(signal.SIGTERM, _on_signal)

    install = Install()
    if args.config:
        with open(args.config) as f:
            install = Install.from_dict(json.load(f))

    scheduler = init_server_with_clients(APIServer(), install, device=args.device)
    http = ExtenderHTTPServer(scheduler, port=args.port, host=args.host)
    http.start()
    print(
        f"extender serving on :{http.port} "
        f"(binpack={install.binpack_algo}, backend=embedded, device={scheduler.device})",
        flush=True,
    )
    try:
        stop_event.wait()
    finally:
        http.stop()
        scheduler.stop()
    return 0


if __name__ == "__main__":
    sys.exit(main())
