"""The decode kernels' measurement probes: a launch floor, the decode
kernel's calling convention, and the seal's lane scatter.

Twins of the Pallas kernels in the JAX package's probe scripts:

* :func:`add_one` (P1a, ``scripts/pallas_launch_probe.py::tiny_kernel``):
  o = x + 1.0, a kernel that does nearly nothing, so a loop of it times the
  cost of one launch;
* :func:`decode_convention` (P1b, ``pallas_launch_probe.py::conv_kernel``):
  the decode kernel's arguments (q, one layer's ring, kv and scales views,
  index), a copy of one window's rows [0, 2) x {K, V} x all heads into fast
  memory, and ctx = q + q.dtype(scales[0, 0, 0, 0, 0]);
* :func:`seal_scatter` (P2, ``scripts/seal_scatter_probe.py::make.kernel``):
  out[h, d, l] = int8(sum_g qc[g, h, d] * oh[g, l]) on the G lanes
  [lane0, lane0 + G) and 0 elsewhere.  The TPU script compared five Mosaic
  lowerings of this one function (``accum``, ``bigsum``, ``batched``,
  ``fused2d``, ``serial``); they differ only in what Mosaic could compile, so
  the port has one kernel.  ``batched`` never traced in JAX at all.

Each wrapper runs its plain PyTorch version (``*_reference``) on a CPU
tensor and launches its CUDA kernel (csrc/probes.cu) on a CUDA tensor, on
the current stream, so a CUDA graph can capture it; anything else raises.
Each counts its launches in ``.launches``.
"""

from __future__ import annotations

import torch

from ._kernels import launch
from .decode_attention import SEAL_GROUP, WRITE_WINDOW

ROWS = 2  # batch rows of window 0 that P1b copies, as the TPU probe's rb


def _on_card(fn: str, x: torch.Tensor) -> bool:
    """True for a CUDA tensor, False for a CPU one; raise on anything else."""
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{fn}: unsupported device {x.device}")
    return x.device.type == "cuda"


def _check_on(fn: str, device: torch.device, **tensors) -> None:
    for name, t in tensors.items():
        if not t.is_contiguous() or t.device != device:
            raise ValueError(f"{fn}: {name} must be contiguous on {device}")


# ------------------------------------------------------------------ #
# P1a: the launch floor
# ------------------------------------------------------------------ #


def add_one_reference(x: torch.Tensor) -> torch.Tensor:
    """x + 1.0."""
    return x + 1.0


def add_one(x: torch.Tensor) -> torch.Tensor:
    """x + 1.0 for a float32 tensor; one block on a CUDA tensor."""
    if not _on_card("add_one", x):
        return add_one_reference(x)
    if x.dtype != torch.float32:
        raise ValueError(f"add_one: x dtype {x.dtype}, float32 expected")
    _check_on("add_one", x.device, x=x)
    o = torch.empty_like(x)
    launch("probes", "probe_add_one", x.device, x.data_ptr(), o.data_ptr(), x.numel())
    add_one.launches += 1
    return o


add_one.launches = 0


# ------------------------------------------------------------------ #
# P1b: the decode kernel's calling convention with one window's copy
# ------------------------------------------------------------------ #


def decode_convention_reference(q: torch.Tensor, ring_l: torch.Tensor, kv_l: torch.Tensor,
                                scales_l: torch.Tensor, index: int) -> torch.Tensor:
    """Copy rows [0, 2) x {K, V} x all heads of window 0 and their scales,
    then q + q.dtype(first copied scale): the scale is rounded to q's dtype
    first and the sum rounded again, as the JAX kernel's bfloat16 add.
    ``ring_l`` and ``index`` are the decode kernel's and are not read."""
    del ring_l, index
    # the copy is the probe's work, as in the kernel; one scale is read back
    _, sbuf = kv_l[0, :ROWS].clone(), scales_l[0, :ROWS].clone()  # [2, 2, N, (D,) W]
    return q + sbuf[0, 0, 0, 0].to(q.dtype)


def decode_convention(q: torch.Tensor, ring_l: torch.Tensor, kv_l: torch.Tensor,
                      scales_l: torch.Tensor, index: int) -> torch.Tensor:
    """P1b with the decode kernel's arguments (q [B, N, D] bfloat16, as in
    the probe and the decode step, ring [G, B, N, 2D] float32, one layer's int8 kv
    [NW, B, 2, N, D, 128] and scales [NW, B, 2, N, 128], index) -> ctx
    [B, N, D] bfloat16.  On a CUDA tensor it launches
    ``probe_decode_convention``, checked as the decode kernel's wrapper
    checks its inputs; on a CPU tensor the plain version."""
    if not _on_card("decode_convention", q):
        return decode_convention_reference(q, ring_l, kv_l, scales_l, index)
    B, N, D = q.shape
    G, W = ring_l.shape[0], WRITE_WINDOW
    NW = kv_l.shape[0]
    if tuple(kv_l.shape) != (NW, B, 2, N, D, W) or kv_l.dtype != torch.int8:
        raise ValueError(f"kv must be int8 [NW, {B}, 2, {N}, {D}, {W}], got "
                         f"{kv_l.dtype} {tuple(kv_l.shape)}")
    if tuple(scales_l.shape) != (NW, B, 2, N, W) or scales_l.dtype != torch.float32:
        raise ValueError(f"scales must be float32 [NW, {B}, 2, {N}, {W}]")
    if tuple(ring_l.shape) != (G, B, N, 2 * D) or ring_l.dtype != torch.float32:
        raise ValueError(f"ring must be float32 [G, {B}, {N}, {2 * D}]")
    if q.dtype != torch.bfloat16:
        raise ValueError(f"q dtype {q.dtype}: bfloat16 expected")
    if B < ROWS or W % D:
        raise ValueError(f"needs batch >= {ROWS} and head_dim dividing {W}")
    if index < 0 or index >= NW * W:
        raise ValueError(f"index {index} outside the cache")
    _check_on("decode_convention", q.device, q=q, ring=ring_l, kv=kv_l, scales=scales_l)
    if kv_l.data_ptr() % 16 or scales_l.data_ptr() % 16:
        raise ValueError("kv and scales views must be 16-byte aligned (16-byte async copies)")
    ctx = torch.empty_like(q)
    launch("probes", "probe_decode_convention", q.device, q.data_ptr(), 1, ring_l.data_ptr(),
           kv_l.data_ptr(), scales_l.data_ptr(), ctx.data_ptr(), B, N, D, NW, G, int(index))
    decode_convention.launches += 1
    return ctx


decode_convention.launches = 0


# ------------------------------------------------------------------ #
# P2: the seal's lane scatter
# ------------------------------------------------------------------ #


def seal_scatter_reference(qc: torch.Tensor, oh: torch.Tensor,
                           lane0: torch.Tensor) -> torch.Tensor:
    """The masked one-hot contraction: qc [G, hb, Dc] float32, oh [G, W]
    float32, lane0 [1, 1] int32 -> [hb, Dc, W] int8, truncated toward zero
    on the lanes [lane0, lane0 + G) and 0 elsewhere.  lane0 stays a tensor
    (no host sync)."""
    G, W = oh.shape
    out = torch.einsum("ghd,gl->hdl", qc, oh)
    lanes = torch.arange(W, device=qc.device)
    l0 = lane0.reshape(())
    grp = (lanes >= l0) & (lanes < l0 + G)
    return torch.where(grp, out.to(torch.int8), torch.zeros((), dtype=torch.int8,
                                                            device=qc.device))


def seal_scatter(qc: torch.Tensor, oh: torch.Tensor, lane0: torch.Tensor) -> torch.Tensor:
    """P2 -> out [hb, Dc, W] int8.  On a CUDA tensor it launches
    ``probe_seal_scatter``, which reads lane0 on the device and takes G =
    SEAL_GROUP and W a multiple of 16 up to 1536 (oh is staged in 48 KB of
    shared memory); on a CPU tensor the plain version."""
    if not _on_card("seal_scatter", qc):
        return seal_scatter_reference(qc, oh, lane0)
    G, hb, Dc = qc.shape
    W = oh.shape[1]
    if G != SEAL_GROUP:
        raise ValueError(f"qc must hold the seal group's {SEAL_GROUP} columns, got {G}")
    if tuple(oh.shape) != (G, W) or W % 16 or W > 1536:
        raise ValueError(f"oh must be [{G}, W] with W a multiple of 16 up to 1536, got "
                         f"{tuple(oh.shape)}")
    if (qc.dtype, oh.dtype, lane0.dtype) != (torch.float32, torch.float32, torch.int32):
        raise ValueError("qc and oh must be float32, lane0 int32")
    if lane0.numel() != 1:
        raise ValueError(f"lane0 must hold one value, got {tuple(lane0.shape)}")
    _check_on("seal_scatter", qc.device, qc=qc, oh=oh, lane0=lane0)
    out = torch.empty((hb, Dc, W), dtype=torch.int8, device=qc.device)
    launch("probes", "probe_seal_scatter", qc.device, qc.data_ptr(), oh.data_ptr(),
           lane0.data_ptr(), out.data_ptr(), G, hb, Dc, W)
    seal_scatter.launches += 1
    return out


seal_scatter.launches = 0
