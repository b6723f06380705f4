"""Exact equivalence-class grouping of node rows on the device (the
reference package's native ``snap_group_rows``, ``native/__init__.py``
``group_rows``).

Rows with identical int64 availability (and an optional per-row flag,
e.g. schedulability) form one class.  Class ids are assigned in
FIRST-OCCURRENCE order, as the reference's one-pass hash assigns them,
so the first row of each class is its representative and class ids
agree with the reference's element for element.  The capacity
observatory's class lane runs its multiplicity-weighted probes over the
classes; class-compressed stepping (ROADMAP A.3b) can reuse the same
grouping.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

_I64 = torch.int64


def group_rows(
    rows: torch.Tensor, flags: Optional[torch.Tensor] = None
) -> Tuple[int, torch.Tensor, torch.Tensor]:
    """(class count, class id per row ``[N]`` int64 in first-occurrence
    order, representative row per class ``[C]`` int64 ascending) of the
    ``[N, 3]`` int64 rows plus an optional ``[N]`` flag, on the rows'
    device.  ``torch.unique`` numbers the classes in sorted order; each
    is renumbered by its smallest row index."""
    rows = rows.to(_I64).reshape(-1, 3)
    n, dev = rows.shape[0], rows.device
    if n == 0:
        return 0, torch.zeros(0, dtype=_I64, device=dev), torch.zeros(0, dtype=_I64, device=dev)
    flag = torch.zeros(n, dtype=_I64, device=dev) if flags is None else flags.to(_I64).reshape(n)
    keys = torch.cat([rows, flag.unsqueeze(1)], dim=1)
    uniq, inverse = torch.unique(keys, dim=0, return_inverse=True)
    n_classes = uniq.shape[0]
    index = torch.arange(n, dtype=_I64, device=dev)
    # rows ordered by (sorted class, row index): each class's first entry
    # holds its smallest row index
    order = torch.argsort(inverse * n + index)
    sorted_cls = inverse[order]
    starts = torch.ones(n, dtype=torch.bool, device=dev)
    starts[1:] = sorted_cls[1:] != sorted_cls[:-1]
    first = torch.empty(n_classes, dtype=_I64, device=dev)
    first[sorted_cls[starts]] = order[starts]
    by_first = torch.argsort(first)
    renumber = torch.empty(n_classes, dtype=_I64, device=dev)
    renumber[by_first] = torch.arange(n_classes, dtype=_I64, device=dev)
    return int(n_classes), renumber[inverse], first[by_first]
