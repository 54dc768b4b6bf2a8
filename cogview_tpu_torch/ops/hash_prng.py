"""Counter-based hash PRNG, bit-exact twin of cogview_tpu/ops/hash_prng.py.

Every random quantity of the sampler is a murmur-style hash of its global
coordinates (step, row, vocab id) and one uint32 seed, so the port draws the
same gumbel noise as the JAX package from the same seed.

torch's uint32 support is partial, so values are held in int64 tensors and
masked to 32 bits after every step.  A product of a 32-bit value and a
32-bit constant can reach 2^64 and overflow int64; :func:`_mul32` splits the
constant into 16-bit halves so every partial product stays below 2^48.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch

_M32 = 0xFFFFFFFF

# distinct odd 32-bit multipliers per coordinate (golden-ratio family)
_C0 = 0x9E3779B1
_C1 = 0x85EBCA77
_C2 = 0xC2B2AE3D


def _u32(x, device=None) -> torch.Tensor:
    """A tensor or Python int -> int64 tensor holding uint32 values."""
    if not isinstance(x, torch.Tensor):
        return torch.tensor(int(x) & _M32, dtype=torch.int64, device=device)
    return x.to(torch.int64) & _M32


def _mul32(a: torch.Tensor, c: int) -> torch.Tensor:
    """(a * c) mod 2^32 for uint32 ``a`` (int64 tensor) and constant ``c``."""
    lo, hi = c & 0xFFFF, c >> 16
    return (a * lo + (((a * hi) & 0xFFFF) << 16)) & _M32


def fmix32(x: torch.Tensor) -> torch.Tensor:
    """murmur3 finalizer variant (uint32 -> well-mixed uint32)."""
    x = x ^ (x >> 16)
    x = _mul32(x, 0x7FEB352D)
    x = x ^ (x >> 15)
    x = _mul32(x, 0x846CA68B)
    x = x ^ (x >> 16)
    return x


def hash_u32(seed, c0, c1, c2) -> torch.Tensor:
    """Well-mixed uint32 (as int64) from a seed and three broadcastable
    uint32 coordinates (tensors or Python ints)."""
    dev = next((t.device for t in (c0, c1, c2, seed)
                if isinstance(t, torch.Tensor)), None)
    x = (_mul32(_u32(c0, dev), _C0) + _mul32(_u32(c1, dev), _C1)
         + _mul32(_u32(c2, dev), _C2)) & _M32
    return fmix32(x ^ _u32(seed, dev))


def hash_uniform(seed, c0, c1, c2) -> torch.Tensor:
    """float32 uniform in the open interval (0, 1) from hashed coordinates.

    (bits + 0.5) * 2^-24 rounds to exactly 1.0 for bits == 2^24 - 1, and
    -log(-log(1.0)) is +inf: a gumbel-max could then pick a masked token.
    Clamp to the largest float32 below 1, as the JAX package does."""
    bits = hash_u32(seed, c0, c1, c2) >> 8
    u = (bits.to(torch.float32) + 0.5) * (2.0 ** -24)
    return torch.clamp(u, max=1.0 - 2.0 ** -24)


def _block_index(shape, origin: Sequence[int], full_shape: Sequence[int],
                 device) -> torch.Tensor:
    """Row-major flat indices mod 2^32, in a tensor of ``full_shape``, of the
    block of ``shape`` at ``origin``; both may name only the leading dims
    (the rest start at 0 and keep their size)."""
    n = len(shape)
    origin = list(origin) + [0] * (n - len(origin))
    full = list(full_shape) + list(shape[len(full_shape):])
    flat = torch.zeros((), dtype=torch.int64, device=device)
    for d in range(n):
        idx = (origin[d] + torch.arange(shape[d], device=device)).reshape(
            [-1 if i == d else 1 for i in range(n)])
        flat = ((flat * full[d]) & _M32) + idx
    return flat & _M32


def hash_dropout(x: torch.Tensor, rate: float, seed: int, salt: int = 0,
                 origin: Optional[Sequence[int]] = None,
                 full_shape: Optional[Sequence[int]] = None) -> torch.Tensor:
    """Inverted dropout with a counter-hash keep mask: element i of x is kept
    iff hash_u32(seed, flat_index(i), salt, 0) >= round(rate * 2^32), and a
    kept value is ``x / (1 - rate)``.  ``salt`` separates call sites that
    share a seed.

    The JAX package builds the flat index per dimension as ``flat * n +
    iota`` in wrapping uint32; that is the row-major linear index mod 2^32,
    which is what is computed here.  Under GSPMD that index is global: a
    shard passes its block's ``origin`` in the whole tensor of
    ``full_shape`` (both may name only the leading dims), and its mask is
    that block of the unsharded mask.  A block along dim 0 alone is the
    flat offset ``origin[0] * (numel / shape[0])``."""
    if rate <= 0.0:
        return x
    if origin is None:
        flat = (torch.arange(x.numel(), device=x.device) & _M32).reshape(x.shape)
    else:
        flat = _block_index(x.shape, origin, full_shape, x.device)
    threshold = min(int(round(rate * 2.0 ** 32)), 2 ** 32 - 1)
    keep = hash_u32(seed, flat, salt, 0) >= threshold
    # a 0-d tensor divisor: CUDA divides by a Python scalar through its
    # reciprocal, which is not the true division
    return torch.where(keep, x / x.new_full((), 1.0 - rate), 0.0)


def seed_from_key_data(data) -> int:
    """uint32 seed from a PRNG key's uint32 words: the arithmetic of the JAX
    package's ``seed_from_key``, ``data[-1] ^ (data[0] << 1)``, wrapped to
    32 bits.  The port itself takes a uint32 seed; this exists so a caller
    holding a JAX key's words can derive the same seed."""
    words = [int(w) & _M32 for w in data]
    return (words[-1] ^ ((words[0] << 1) & _M32)) & _M32
