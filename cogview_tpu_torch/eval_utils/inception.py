"""InceptionV3 feature extractor (twin of cogview_tpu/eval_utils/inception.py).

torchvision's ``inception_v3`` architecture as an ``nn.Module`` tree whose
parameter names are torchvision's state-dict keys (``Conv2d_1a_3x3.conv.
weight`` ... ``Mixed_7c.branch_pool.bn.running_var``, ``fc.weight``), so a
torchvision state dict loads with :func:`load_torchvision_state_dict`
(``AuxLogits.*`` keys are ignored: this is the eval-time network).
BasicConv2d is a conv without bias, BatchNorm with eps 1e-3 on its running
statistics, and ReLU; the 1x7 / 7x1 and 1x3 / 3x1 convs pad only along
their long side; the branch pools average over 3 x 3 with the padding
counted (the divisor is always 9).

The public functions take the JAX package's NHWC images in (0, 1) and
return its layouts (block outputs NHWC, pool3 [B, 2048]), with the same
preprocessing: a separable bilinear resize to 299 as two interpolation
matmuls (align_corners True for features, False for the IS logits) and the
0.5 -> ImageNet renormalization.  Without weights, :func:`init_model`
draws a seeded random network of the JAX ``init_params`` distributions (He
truncated normals, so ~94 ReLU layers do not collapse the features; not
its numbers).
"""

from __future__ import annotations

import math
from typing import Any, Dict, List, Sequence

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

BLOCK_INDEX_BY_DIM = {64: 0, 192: 1, 768: 2, 2048: 3}
DEFAULT_BLOCK_INDEX = 3
BN_EPS = 1e-3  # torchvision BasicConv2d BatchNorm2d(eps=0.001)


class BasicConv2d(nn.Module):
    def __init__(self, cin: int, cout: int, kernel, stride=1, padding=0):
        super().__init__()
        self.conv = nn.Conv2d(cin, cout, kernel, stride=stride, padding=padding, bias=False)
        self.bn = nn.BatchNorm2d(cout, eps=BN_EPS)

    def forward(self, x):
        return F.relu(self.bn(self.conv(x)))


def _avg_pool(x):
    """F.avg_pool2d(3, 1, 1) with the padding counted: divisor 9."""
    return F.avg_pool2d(x, 3, stride=1, padding=1, count_include_pad=True)


def _max_pool(x):
    return F.max_pool2d(x, 3, stride=2)


class InceptionA(nn.Module):
    def __init__(self, cin: int, pool_features: int):
        super().__init__()
        self.branch1x1 = BasicConv2d(cin, 64, 1)
        self.branch5x5_1 = BasicConv2d(cin, 48, 1)
        self.branch5x5_2 = BasicConv2d(48, 64, 5, padding=2)
        self.branch3x3dbl_1 = BasicConv2d(cin, 64, 1)
        self.branch3x3dbl_2 = BasicConv2d(64, 96, 3, padding=1)
        self.branch3x3dbl_3 = BasicConv2d(96, 96, 3, padding=1)
        self.branch_pool = BasicConv2d(cin, pool_features, 1)

    def forward(self, x):
        b5 = self.branch5x5_2(self.branch5x5_1(x))
        bd = self.branch3x3dbl_3(self.branch3x3dbl_2(self.branch3x3dbl_1(x)))
        return torch.cat([self.branch1x1(x), b5, bd, self.branch_pool(_avg_pool(x))], 1)


class InceptionB(nn.Module):
    def __init__(self, cin: int):
        super().__init__()
        self.branch3x3 = BasicConv2d(cin, 384, 3, stride=2)
        self.branch3x3dbl_1 = BasicConv2d(cin, 64, 1)
        self.branch3x3dbl_2 = BasicConv2d(64, 96, 3, padding=1)
        self.branch3x3dbl_3 = BasicConv2d(96, 96, 3, stride=2)

    def forward(self, x):
        bd = self.branch3x3dbl_3(self.branch3x3dbl_2(self.branch3x3dbl_1(x)))
        return torch.cat([self.branch3x3(x), bd, _max_pool(x)], 1)


class InceptionC(nn.Module):
    def __init__(self, cin: int, c7: int):
        super().__init__()
        self.branch1x1 = BasicConv2d(cin, 192, 1)
        self.branch7x7_1 = BasicConv2d(cin, c7, 1)
        self.branch7x7_2 = BasicConv2d(c7, c7, (1, 7), padding=(0, 3))
        self.branch7x7_3 = BasicConv2d(c7, 192, (7, 1), padding=(3, 0))
        self.branch7x7dbl_1 = BasicConv2d(cin, c7, 1)
        self.branch7x7dbl_2 = BasicConv2d(c7, c7, (7, 1), padding=(3, 0))
        self.branch7x7dbl_3 = BasicConv2d(c7, c7, (1, 7), padding=(0, 3))
        self.branch7x7dbl_4 = BasicConv2d(c7, c7, (7, 1), padding=(3, 0))
        self.branch7x7dbl_5 = BasicConv2d(c7, 192, (1, 7), padding=(0, 3))
        self.branch_pool = BasicConv2d(cin, 192, 1)

    def forward(self, x):
        b7 = self.branch7x7_3(self.branch7x7_2(self.branch7x7_1(x)))
        bd = x
        for k in range(1, 6):
            bd = getattr(self, f"branch7x7dbl_{k}")(bd)
        return torch.cat([self.branch1x1(x), b7, bd, self.branch_pool(_avg_pool(x))], 1)


class InceptionD(nn.Module):
    def __init__(self, cin: int):
        super().__init__()
        self.branch3x3_1 = BasicConv2d(cin, 192, 1)
        self.branch3x3_2 = BasicConv2d(192, 320, 3, stride=2)
        self.branch7x7x3_1 = BasicConv2d(cin, 192, 1)
        self.branch7x7x3_2 = BasicConv2d(192, 192, (1, 7), padding=(0, 3))
        self.branch7x7x3_3 = BasicConv2d(192, 192, (7, 1), padding=(3, 0))
        self.branch7x7x3_4 = BasicConv2d(192, 192, 3, stride=2)

    def forward(self, x):
        b3 = self.branch3x3_2(self.branch3x3_1(x))
        b7 = x
        for k in range(1, 5):
            b7 = getattr(self, f"branch7x7x3_{k}")(b7)
        return torch.cat([b3, b7, _max_pool(x)], 1)


class InceptionE(nn.Module):
    def __init__(self, cin: int):
        super().__init__()
        self.branch1x1 = BasicConv2d(cin, 320, 1)
        self.branch3x3_1 = BasicConv2d(cin, 384, 1)
        self.branch3x3_2a = BasicConv2d(384, 384, (1, 3), padding=(0, 1))
        self.branch3x3_2b = BasicConv2d(384, 384, (3, 1), padding=(1, 0))
        self.branch3x3dbl_1 = BasicConv2d(cin, 448, 1)
        self.branch3x3dbl_2 = BasicConv2d(448, 384, 3, padding=1)
        self.branch3x3dbl_3a = BasicConv2d(384, 384, (1, 3), padding=(0, 1))
        self.branch3x3dbl_3b = BasicConv2d(384, 384, (3, 1), padding=(1, 0))
        self.branch_pool = BasicConv2d(cin, 192, 1)

    def forward(self, x):
        b3 = self.branch3x3_1(x)
        b3 = torch.cat([self.branch3x3_2a(b3), self.branch3x3_2b(b3)], 1)
        bd = self.branch3x3dbl_2(self.branch3x3dbl_1(x))
        bd = torch.cat([self.branch3x3dbl_3a(bd), self.branch3x3dbl_3b(bd)], 1)
        return torch.cat([self.branch1x1(x), b3, bd, self.branch_pool(_avg_pool(x))], 1)


class InceptionV3(nn.Module):
    """The eval-time network: stem, Mixed_5b ... Mixed_7c, and the fc head
    (``with_fc``)."""

    def __init__(self, with_fc: bool = True):
        super().__init__()
        self.Conv2d_1a_3x3 = BasicConv2d(3, 32, 3, stride=2)
        self.Conv2d_2a_3x3 = BasicConv2d(32, 32, 3)
        self.Conv2d_2b_3x3 = BasicConv2d(32, 64, 3, padding=1)
        self.Conv2d_3b_1x1 = BasicConv2d(64, 80, 1)
        self.Conv2d_4a_3x3 = BasicConv2d(80, 192, 3)
        self.Mixed_5b = InceptionA(192, 32)
        self.Mixed_5c = InceptionA(256, 64)
        self.Mixed_5d = InceptionA(288, 64)
        self.Mixed_6a = InceptionB(288)
        self.Mixed_6b = InceptionC(768, 128)
        self.Mixed_6c = InceptionC(768, 160)
        self.Mixed_6d = InceptionC(768, 160)
        self.Mixed_6e = InceptionC(768, 192)
        self.Mixed_7a = InceptionD(768)
        self.Mixed_7b = InceptionE(1280)
        self.Mixed_7c = InceptionE(2048)
        self.fc = nn.Linear(2048, 1000) if with_fc else None

    def blocks(self, x, last: int = 3) -> List[torch.Tensor]:
        """NCHW x -> the outputs of blocks 0..last (block 3 pooled [B, 2048])."""
        out = []
        x = _max_pool(self.Conv2d_2b_3x3(self.Conv2d_2a_3x3(self.Conv2d_1a_3x3(x))))
        out.append(x)
        if last >= 1:
            x = _max_pool(self.Conv2d_4a_3x3(self.Conv2d_3b_1x1(x)))
            out.append(x)
        if last >= 2:
            for name in ("Mixed_5b", "Mixed_5c", "Mixed_5d", "Mixed_6a", "Mixed_6b",
                         "Mixed_6c", "Mixed_6d", "Mixed_6e"):
                x = getattr(self, name)(x)
            out.append(x)
        if last >= 3:
            x = self.Mixed_7c(self.Mixed_7b(self.Mixed_7a(x)))
            out.append(torch.mean(x, dim=(2, 3)))  # AdaptiveAvgPool2d((1, 1))
        return out


def _interp_matrix(n_in: int, n_out: int, align_corners: bool) -> np.ndarray:
    if n_in == n_out:
        return np.eye(n_out, dtype=np.float32)
    out = np.arange(n_out, dtype=np.float64)
    if align_corners:
        src = out * (n_in - 1) / (n_out - 1) if n_out > 1 else np.zeros_like(out)
    else:
        src = np.clip((out + 0.5) * n_in / n_out - 0.5, 0.0, n_in - 1)
    lo = np.floor(src).astype(np.int64)
    hi = np.minimum(lo + 1, n_in - 1)
    frac = src - lo
    w = np.zeros((n_out, n_in))
    w[np.arange(n_out), lo] += 1.0 - frac
    w[np.arange(n_out), hi] += frac
    return w.astype(np.float32)


def bilinear_resize(x: torch.Tensor, size: int, align_corners: bool) -> torch.Tensor:
    """[B, H, W, C] -> [B, size, size, C], separable bilinear with torch's
    F.interpolate semantics for both align_corners settings, as two dense
    [out, in] interpolation matmuls (the JAX package's form)."""
    wh = torch.from_numpy(_interp_matrix(x.shape[1], size, align_corners)).to(x.device)
    ww = torch.from_numpy(_interp_matrix(x.shape[2], size, align_corners)).to(x.device)
    y = torch.einsum("oh,bhwc->bowc", wh, x.float())
    return torch.einsum("ow,bhwc->bhoc", ww, y)


def _nchw(x):
    return x.permute(0, 3, 1, 2)


@torch.no_grad()
def features(model: InceptionV3, x: torch.Tensor,
             output_blocks: Sequence[int] = (DEFAULT_BLOCK_INDEX,),
             resize_input: bool = True, normalize_input: bool = True) -> List[torch.Tensor]:
    """x: [B, H, W, 3] in (0, 1) -> the selected block outputs, NHWC (block
    3 is [B, 2048])."""
    output_blocks = sorted(output_blocks)
    last = max(output_blocks)
    assert last <= 3
    x = x.float()
    if resize_input:
        x = bilinear_resize(x, 299, align_corners=True)
    if normalize_input:
        scale = torch.tensor([0.229, 0.224, 0.225], device=x.device) / 0.5
        shift = (torch.tensor([0.485, 0.456, 0.406], device=x.device) - 0.5) / 0.5
        x = x * scale + shift
    out = model.blocks(_nchw(x), last)
    return [out[b] if b == 3 else out[b].permute(0, 2, 3, 1) for b in output_blocks]


def pool3_features(model: InceptionV3, x: torch.Tensor) -> torch.Tensor:
    """FID's 2048-d activations."""
    return features(model, x, (3,))[0]


@torch.no_grad()
def logits(model: InceptionV3, x: torch.Tensor, resize_input: bool = False) -> torch.Tensor:
    """Classifier logits [B, 1000] for the Inception Score: x already in
    (-1, 1), an align_corners=False resize, no renormalization."""
    x = x.float()
    if resize_input:
        x = bilinear_resize(x, 299, align_corners=False)
    return model.fc(model.blocks(_nchw(x), 3)[3])


# --------------------------------------------------------------------- #
# weights: seeded random init, torchvision and JAX converters
# --------------------------------------------------------------------- #


@torch.no_grad()
def init_model(seed: int = 0, with_fc: bool = True, device=None) -> InceptionV3:
    """A random network, eval mode, drawn on the CPU from ``seed``: convs
    truncated normal in [-2, 2] x sqrt(2 / fan_in), BN scale 1, bias 0.1 x
    N(0, 1), mean 0, var |N(0, 1)| + 0.5; fc N(0, 1) x 0.01, bias 0."""
    gen = torch.Generator().manual_seed(seed)
    model = InceptionV3(with_fc)
    for m in model.modules():
        if isinstance(m, BasicConv2d):
            w = m.conv.weight
            fan_in = w.shape[1] * w.shape[2] * w.shape[3]
            nn.init.trunc_normal_(w, 0.0, 1.0, -2.0, 2.0, generator=gen)
            w.mul_(math.sqrt(2.0 / fan_in))
            m.bn.weight.fill_(1.0)
            m.bn.bias.copy_(0.1 * torch.randn(w.shape[0], generator=gen))
            m.bn.running_mean.zero_()
            m.bn.running_var.copy_(torch.randn(w.shape[0], generator=gen).abs() + 0.5)
    if with_fc:
        model.fc.weight.copy_(torch.randn(1000, 2048, generator=gen) * 0.01)
        model.fc.bias.zero_()
    model.eval()
    return model if device is None else model.to(device)


def load_torchvision_state_dict(model: InceptionV3, sd: Dict[str, Any]) -> InceptionV3:
    """Load a torchvision ``inception_v3`` state dict (``AuxLogits.*``
    ignored; ``fc.*`` only where the model has its head); every other key
    must be there."""
    keep = {k: v for k, v in sd.items() if not k.startswith("AuxLogits.")
            and (model.fc is not None or not k.startswith("fc."))}
    missing, unexpected = model.load_state_dict(keep, strict=False)
    missing = [k for k in missing if not k.endswith("num_batches_tracked")]
    if missing or unexpected:
        raise ValueError(f"not an inception_v3 state dict: missing {missing[:4]}, "
                         f"unexpected {unexpected[:4]}")
    return model.eval()


def load_model(path: str, device=None) -> InceptionV3:
    """A torchvision ``.pth``/``.pt`` state dict (or an ``{'state_dict':
    ...}`` wrapper) from disk."""
    sd = torch.load(path, map_location="cpu", weights_only=True)
    if isinstance(sd, dict) and "state_dict" in sd:
        sd = sd["state_dict"]
    model = InceptionV3(with_fc="fc.weight" in sd)
    model = load_torchvision_state_dict(model, sd)
    return model if device is None else model.to(device)


def state_dict_from_jax_params(params: Dict[str, Any]) -> Dict[str, torch.Tensor]:
    """The JAX package's params (HWIO convs, ``bn.{scale, bias, mean,
    var}``, ``fc.w`` [2048, 1000]) as numpy -> a torchvision state dict."""
    sd = {}

    def conv(prefix, p):
        sd[f"{prefix}.conv.weight"] = torch.from_numpy(
            np.ascontiguousarray(np.asarray(p["w"], np.float32).transpose(3, 2, 0, 1)))
        for ours, theirs in (("weight", "scale"), ("bias", "bias"), ("running_mean", "mean"),
                             ("running_var", "var")):
            sd[f"{prefix}.bn.{ours}"] = torch.from_numpy(np.array(p["bn"][theirs], np.float32))

    for mod, tree in params.items():
        if mod == "fc":
            sd["fc.weight"] = torch.from_numpy(np.ascontiguousarray(np.asarray(tree["w"]).T))
            sd["fc.bias"] = torch.from_numpy(np.array(tree["b"], np.float32))
        elif "w" in tree:
            conv(mod, tree)
        else:
            for name, p in tree.items():
                conv(f"{mod}.{name}", p)
    return sd
