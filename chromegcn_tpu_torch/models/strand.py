"""Non-strand-specific wrapper: run both strands, average the *logits*
(port of chromegcn_tpu/models/strand.py; reference:
models/NonStrandSpecific.py:47-97).

Both strands share one weight set, so they run as one call on the 2B batch
``[tokens; reverse_complement(tokens)]``. In train mode BatchNorm statistics
are therefore taken once over the 2B batch, as the JAX package documents
(strand.py:12-16), and not per strand as the torch reference's two passes
take them. Eval mode is the same either way.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
from torch import nn

from chromegcn_tpu_torch.ops.seq import reverse_complement


class NonStrandSpecific(nn.Module):
    """Wraps a window model: returns (x_fwd, x_rev, mean of the two strands'
    logits) for (B, L) tokens and the (V,) complement permutation; train or
    eval mode is the module's."""

    def __init__(self, model: nn.Module):
        super().__init__()
        self.model = model

    def forward(
        self,
        tokens: torch.Tensor,
        comp_map: torch.Tensor,
        generator: Optional[torch.Generator] = None,
    ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        b = tokens.shape[0]
        both = torch.cat([tokens, reverse_complement(tokens, comp_map).to(tokens.dtype)], 0)
        x_both, y_both = self.model(both, generator=generator)
        return x_both[:b], x_both[b:], (y_both[:b] + y_both[b:]) / 2.0
