"""Prep modules: how gathered node features become layer-0 inputs
(counterpart of ``tpu_sage/nn/preps.py``).

Only ``identity`` is ported; ``linear`` and ``node_embedding`` are ROADMAP
Queue 1 item 8.
"""

from __future__ import annotations

from typing import Optional

import torch


class IdentityPrep(torch.nn.Module):
    """Pass gathered raw features through unchanged."""

    def forward(self, ids: torch.Tensor, x: Optional[torch.Tensor]) -> torch.Tensor:
        if x is None:
            raise ValueError("IdentityPrep requires node features")
        return x


prep_lookup = {"identity": IdentityPrep}
