"""LayerNorm with PB-relax folded into eps (twin of cogview_tpu/ops/layernorm.py).

The reference computes ``LN(x / (max|x| / 8))``; LN_eps(x/c) == LN_{eps*c^2}(x)
exactly, so the prescale becomes an eps correction.  The max is over the
WHOLE tensor (batch, sequence and hidden), as in the reference.
"""

from __future__ import annotations

import torch


def layer_norm(x: torch.Tensor, g: torch.Tensor, b: torch.Tensor,
               eps: float = 1e-5, pb_relax: bool = True) -> torch.Tensor:
    """x: [..., H]; g/b: [H].  Statistics in float32; output in x.dtype."""
    xf = x.float()
    if pb_relax:
        c = xf.abs().max() / 8.0
        eps = eps * torch.square(c)
    mean = xf.mean(dim=-1, keepdim=True)
    var = torch.square(xf - mean).mean(dim=-1, keepdim=True)
    y = (xf - mean) * torch.rsqrt(var + eps)
    y = y * g.float() + b.float()
    return y.to(x.dtype)
