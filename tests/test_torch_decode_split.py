"""The decode kernels' split over windows, on the CPU: the split plan, a
plain split-and-merge computation that mirrors the kernels' algorithm held
against the port's plain version and the JAX kernel in interpret mode, and
the head dims the CUDA source dispatches on.

The kernels (csrc/decode_attention.cu) run ``split_plan(B, N, NW)`` blocks
per (row, head); split s streams windows s, s + splits, ... and keeps its
own softmax state (max m, sum l, P.V), split 0 with the exact ring slots;
the partials merge in split order.  Only the card runs the kernels
(tests/test_torch_kernels_cuda.py); here the same arithmetic runs in
float32 PyTorch at every split count."""

import functools
import inspect
import math
import re
from pathlib import Path

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from cogview_tpu.ops import decode_attention as jda
from cogview_tpu_torch.ops import decode_attention as tda

torch.set_num_threads(1)

G, W = tda.SEAL_GROUP, tda.WRITE_WINDOW
L, B, N, D = 2, 2, 4, 16
NW = 4
EMPTY = -1e30  # the kernels' running max over no column


def test_split_plan_depends_on_the_shapes_alone():
    """(B, N, NW) in, a split count in [1, NW] out: cogview-base (40 heads,
    9 windows) splits its window loop 4 ways at batch 4 and not at all at
    batch 40; a single (row, head) takes one block per window."""
    assert list(inspect.signature(tda.split_plan).parameters) == ["batch", "heads",
                                                                  "num_windows"]
    assert tda.split_plan(4, 40, 9) == 4
    assert tda.split_plan(40, 40, 9) == 1
    assert tda.split_plan(1, 1, 9) == 9 and tda.split_plan(1, 1, 1) == 1
    for b in (1, 2, 4, 8, 16, 40):
        for nw in (1, 2, 9):
            s = tda.split_plan(b, 40, nw)
            assert 1 <= s <= nw
            assert b * 40 * s >= min(tda.SPLIT_TARGET_BLOCKS, b * 40 * nw)


@pytest.mark.parametrize("num_windows", [1, 2, 4, 9])
def test_splits_cover_every_window_once_at_every_index(num_windows):
    """At every index of a cache of ``num_windows`` windows and every split
    count up to it, the splits' windows are the streamed windows
    [0, max(ceil(c0 / 128), 1)), each exactly once."""
    for splits in range(1, num_windows + 1):
        for index in range(num_windows * W):
            got = sorted(w for s in range(splits) for w in tda.split_windows(s, splits, index))
            assert got == list(range(tda.streamed_windows(index)))
            assert got[-1] < num_windows
    assert tda.streamed_windows(7) == 1 and tda.streamed_windows(135) == 1
    assert tda.streamed_windows(136) == 2 and tda.streamed_windows(1088) == 9


def _inputs(packed, seed=0):
    """Numpy layers in the JAX package's column form: q, K/V bytes, scales,
    the split ring.  Dequantized values stay within about 1.3, so float32
    sums keep 1e-5."""
    rng = np.random.RandomState(seed)
    T, Dc = NW * W, D // 2 if packed else D
    q = rng.randn(B, N, D).astype(np.float32)
    if packed:  # bytes the packer makes: 16 * hi + lo + 8, hi, lo in [-7, 7]
        k, v = ((16 * rng.randint(-7, 8, (L, B, N, Dc, T)) + rng.randint(-7, 8, (L, B, N, Dc, T))
                 + 8).astype(np.int8) for _ in range(2))
        smax = 0.18
    else:
        k, v = (rng.randint(-127, 128, (L, B, N, Dc, T)).astype(np.int8) for _ in range(2))
        smax = 0.01
    ks, vs = ((rng.rand(L, B, N, T) * smax).astype(np.float32) for _ in range(2))
    ring = rng.randn(L, G, B, 2, N, D).astype(np.float32)
    return q, k, v, ks, vs, ring


def _port_layer(inputs, li=1):
    q, k, v, ks, vs, ring = inputs
    return (torch.from_numpy(q), tda.fuse_ring(torch.from_numpy(ring))[li],
            tda.fused_from_columns(torch.from_numpy(k), torch.from_numpy(v))[li],
            tda.fused_from_columns(torch.from_numpy(ks), torch.from_numpy(vs))[li])


def split_merge(q, ring_l, kv_l, scales_l, index, splits):
    """The kernels' algorithm in plain float32 PyTorch -> ctx [B, N, D]:
    each split's softmax state over its windows' logits (and, in split 0,
    the ring slots g <= rem) relative to its own max, merged in split
    order.  The cache is read only (the seal is the plain version's)."""
    NW_, B_, _, N_, Dc, W_ = kv_l.shape
    D_ = q.shape[2]
    rem = index % G
    c0 = index - rem
    packed = Dc != D_
    qs = q.float() * (1.0 / math.sqrt(D_))
    parts = []
    for split in range(splits):
        logits, values = [], []
        for w in tda.split_windows(split, splits, index):
            if packed:
                k_hi, k_lo = tda._unpack4(kv_l[w, :, 0])
                s = (torch.einsum("bnd,bndt->bnt", qs[..., :Dc], k_hi)
                     + torch.einsum("bnd,bndt->bnt", qs[..., Dc:], k_lo))
                vcols = torch.cat(tda._unpack4(kv_l[w, :, 1]), dim=2)
            else:
                s = torch.einsum("bnd,bndt->bnt", qs, kv_l[w, :, 0].float())
                vcols = kv_l[w, :, 1].float()
            s = torch.where(w * W_ + torch.arange(W_) < c0, s * scales_l[w, :, 0], tda.MASK_VALUE)
            logits.append(s)
            values.append(scales_l[w, :, 1][:, :, None, :] * vcols)  # [B, N, D, W]
        if split == 0:
            logits.append(torch.einsum("bnd,gbnd->bng", qs, ring_l[:rem + 1, ..., :D_]))
            values.append(ring_l[:rem + 1, ..., D_:].permute(1, 2, 3, 0))
        if not logits:
            parts.append((torch.full((B_, N_), EMPTY), torch.zeros(B_, N_),
                          torch.zeros(B_, N_, D_)))
            continue
        m = torch.cat(logits, dim=-1).amax(dim=-1)
        ps = [torch.exp(s - m[..., None]) for s in logits]
        l = sum(p.sum(dim=-1) for p in ps)
        acc = sum(torch.einsum("bnt,bndt->bnd", p, v) for p, v in zip(ps, values))
        parts.append((m, l, acc))
    M = torch.full((B_, N_), EMPTY)
    l_tot = torch.zeros(B_, N_)
    acc_tot = torch.zeros(B_, N_, D_)
    for m, l, acc in parts:  # split order, online, as the kernels' last block
        M_new = torch.maximum(M, m)
        r, e = torch.exp(M - M_new), torch.exp(m - M_new)
        l_tot = l_tot * r + l * e
        acc_tot = acc_tot * r[..., None] + acc * e[..., None]
        M = M_new
    return acc_tot / l_tot[..., None]


@functools.lru_cache(maxsize=None)
def _jax_ctx(packed, index):
    q, k, v, ks, vs, ring = _inputs(packed)
    ctx, _, _ = jda.decode_attention_quant(
        jnp.asarray(q), jda.fuse_ring(ring), jda.fused_from_columns(jnp.asarray(k), jnp.asarray(v)),
        jda.fused_from_columns(jnp.asarray(ks), jnp.asarray(vs)), 1, index, head_block=4)
    return np.asarray(ctx)


@pytest.mark.parametrize("splits", range(1, NW + 1))
@pytest.mark.parametrize("index", [3, 135, 300, 511])
@pytest.mark.parametrize("packed", [False, True], ids=["int8", "int4"])
def test_split_and_merge_matches_plain_version_and_jax_kernel(packed, index, splits):
    """At every split count the merged partials give the plain version's
    ctx and the JAX kernel's (interpret mode) within 1e-5, float32: index 3
    masks every sealed column (c0 = 0, only the ring counts), 135 seals on
    a window boundary, 300 leaves split 3 of 4 without a window, 511 is the
    cache's last slot."""
    q, ring_l, kv_l, scales_l = _port_layer(_inputs(packed))
    got = split_merge(q, ring_l, kv_l, scales_l, index, splits)
    want = tda.decode_attention_quant_reference(q, ring_l.clone(), kv_l.clone(),
                                                scales_l.clone(), index)
    assert got.shape == want.shape == (B, N, D)
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=1e-5, rtol=0)
    np.testing.assert_allclose(got.numpy(), _jax_ctx(packed, index), atol=1e-5, rtol=0)


@pytest.mark.parametrize("packed", [False, True], ids=["int8", "int4"])
def test_head_dims_match_the_kernels_dispatch(packed):
    """TILE_WIDTHS is the set of tile widths csrc/decode_attention.cu's
    ``with_tile_width`` switch instantiates, so the wrapper and the C entry
    points cannot drift apart; a tile's rows (DT for the int8 cache, DT / 2
    for the int4 cache) split over the kernel's four lane groups, in pairs
    from 8 rows up (``row_of``), one row a group at 4, and the widest is
    256."""
    src = (Path(tda.__file__).resolve().parent.parent / "csrc"
           / "decode_attention.cu").read_text()
    body = src[src.index("cudaError_t with_tile_width("):]
    body = body[:body.index("default:")]
    pairs = re.findall(r"case (\d+): return f\(std::integral_constant<int, (\d+)>", body)
    assert pairs and all(a == b for a, b in pairs)
    assert tuple(sorted(int(a) for a, _ in pairs)) == tda.TILE_WIDTHS
    rows = [w // 2 if packed else w for w in tda.TILE_WIDTHS]
    assert all(r % 8 == 0 or r == 4 for r in rows) and tda.TILE_WIDTHS[-1] == 256


def test_cpu_tensors_run_the_plain_version_at_any_split_count():
    """On the CPU the wrapper runs the plain version whatever ``splits``
    says, and launches nothing."""
    q, ring_l, kv_l, scales_l = _port_layer(_inputs(False))
    calls, launches = tda.decode_attention_quant_reference.calls, tda.decode_attention_quant.launches
    got = tda.decode_attention_quant(q, ring_l, kv_l, scales_l, 300, splits=3)
    want = tda.decode_attention_quant_reference(q, ring_l, kv_l, scales_l, 300)
    assert torch.equal(got, want)
    assert tda.decode_attention_quant_reference.calls == calls + 2
    assert tda.decode_attention_quant.launches == launches
