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


def seed_from_key_data(data) -> int:
    """uint32 seed from a PRNG key's uint32 words: the arithmetic of the JAX
    package's ``seed_from_key``, ``data[-1] ^ (data[0] << 1)``, wrapped to
    32 bits.  The port itself takes a uint32 seed; this exists so a caller
    holding a JAX key's words can derive the same seed."""
    words = [int(w) & _M32 for w in data]
    return (words[-1] ^ ((words[0] << 1) & _M32)) & _M32
