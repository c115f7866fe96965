"""Fixed-capacity compaction (the port of ``utils/gather.py``)."""
from __future__ import annotations

from typing import Tuple

import torch


def masked_gather(mask: torch.Tensor, capacity: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Indices of the first ``capacity`` True rows, in order.

    Returns (idx [capacity] i32, out_valid [capacity] bool); rows past the
    mask's population are invalid and point at row 0. Overflow drops the
    highest indices.
    """
    order = torch.sort((~mask).to(torch.int8), stable=True).indices
    idx = order[:capacity]
    out_valid = mask[idx]
    idx = torch.where(out_valid, idx, torch.zeros_like(idx))
    return idx.to(torch.int32), out_valid
