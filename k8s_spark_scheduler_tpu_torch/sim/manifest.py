"""Self-describing run manifests (shared by sim runs and lab cells); a
copy of the reference package's ``sim/manifest.py``.

Every artifact directory gets a ``run_manifest.json`` recording what
produced it (seed, scenario/spec digests) and a sha256-addressed list
of the sibling artifacts — so a directory of simulation output can be
audited, diffed, or re-verified without the command line that made it.
"""

from __future__ import annotations

import hashlib
import json
import os
from typing import Dict, Optional

MANIFEST_SCHEMA = "tpu-gang-scheduler-run-manifest"
MANIFEST_VERSION = 1
MANIFEST_NAME = "run_manifest.json"


def _sha256_file(path: str) -> str:
    h = hashlib.sha256()
    with open(path, "rb") as f:
        for chunk in iter(lambda: f.read(1 << 20), b""):
            h.update(chunk)
    return h.hexdigest()


def build_run_manifest(
    out_dir: str,
    *,
    kind: str,
    seed: Optional[int] = None,
    digests: Optional[Dict[str, str]] = None,
    extra: Optional[Dict] = None,
) -> Dict:
    """Hash every artifact already present in ``out_dir`` (except the
    manifest itself) and assemble the manifest document."""
    artifacts = []
    for name in sorted(os.listdir(out_dir)):
        path = os.path.join(out_dir, name)
        if name == MANIFEST_NAME or not os.path.isfile(path):
            continue
        artifacts.append(
            {
                "name": name,
                "sha256": _sha256_file(path),
                "bytes": os.path.getsize(path),
            }
        )
    doc: Dict = {
        "schema": MANIFEST_SCHEMA,
        "version": MANIFEST_VERSION,
        "kind": kind,
        "artifacts": artifacts,
    }
    if seed is not None:
        doc["seed"] = seed
    if digests:
        doc["digests"] = dict(sorted(digests.items()))
    if extra:
        doc.update(extra)
    return doc


def write_run_manifest(out_dir: str, **kwargs) -> Dict:
    """Build and write ``run_manifest.json`` into ``out_dir``."""
    doc = build_run_manifest(out_dir, **kwargs)
    path = os.path.join(out_dir, MANIFEST_NAME)
    with open(path, "w") as f:
        json.dump(doc, f, indent=2, sort_keys=True)
        f.write("\n")
    return doc
