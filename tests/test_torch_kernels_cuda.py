"""The port's CUDA kernels against their plain PyTorch versions, on a card.

Every test here needs an NVIDIA GPU and nvcc (the kernels have no CPU mode)
and skips itself elsewhere.  The module imports torch and the port only, so
it runs on a machine without jax:

    python -m pytest tests/test_torch_kernels_cuda.py --noconftest -q
"""

import pytest
import torch

from cogview_tpu_torch.ops import decode_attention as da
from cogview_tpu_torch.ops import flash_attention as fa
from cogview_tpu_torch.ops import probes
from cogview_tpu_torch.scripts import _timing, launch_probe, seal_scatter_probe


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


# the flash kernels' head dims here: every tile width, and dims between them
# (8 in the 16 tile, 33 odd with 66-byte bf16 heads, 80, 100 with 200-byte
# ones); the decode kernels' likewise, the int4 cache at even D only
FLASH_DIMS = tuple(sorted(fa.TILE_WIDTHS + (8, 33, 80, 100)))
DECODE_CASES = [(packed, d) for packed in (False, True)
                for d in sorted(da.TILE_WIDTHS + (24, 33, 80, 100))
                if not (packed and d % 2)]


def _shape(d):
    """(B, N) of a case: cogview-base's at D = 64, small at the other widths."""
    return (4, 40) if d == 64 else (2, 4)


@pytest.mark.cuda
@pytest.mark.parametrize("d", FLASH_DIMS)
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4), (torch.bfloat16, 2e-2)])
@pytest.mark.parametrize("s,sep,rate,q_scale", [(77, 5, 0.0, 1.0), (1058, 0, 0.0, 1.0),
                                                (1089, 100, 0.0, 1.0), (333, 40, 0.1, 1.0),
                                                (128, 64, 0.0, 1.0), (64, 0, 0.0, 1.0),
                                                (1088, 0, 0.1, 1.0), (333, 0, 0.0, 8.0),
                                                (1344, 0, 0.1, 1.0)])
def test_flash_kernel_matches_plain_version(cuda_device, dtype, tol, s, sep, rate, q_scale, d):
    """The flash kernel on strided views of a fused QKV tensor (at D = 64
    cogview-base head shapes): o within ``tol`` (bfloat16: one rounding of o
    and of the probabilities), lse within 1e-4.  Besides a ragged S, prefixes
    that cross tiles and dropout: the unmasked tiles' edges (S = 128 with the
    prefix ending on a tile edge, S = 64 one full tile), the tutorial's
    training shape (S = 1088, sep 0, dropout 0.1), super-resolution
    finetuning's (S = 1344 = 21 x 64), and q scaled by 8, which
    puts the rows' largest logits near 25 (the bf16 kernel sums in the log2
    domain and converts once, lse = (m2 + log2 l) ln 2)."""
    b, n = _shape(d)
    q, k, v = _flash_inputs(cuda_device, dtype, b, s, n, d, q_scale)
    kw = dict(dropout_rate=rate, dropout_seed=1234 if rate else None)
    before = fa.flash_attention.launches
    o, lse = fa.flash_attention(q, k, v, sep, **kw)
    torch.cuda.synchronize()
    assert fa.flash_attention.launches == before + 1
    ro, rlse = fa.flash_attention_reference(q, k, v, sep, **kw)
    assert o.dtype == dtype and o.shape == (b, s, n, d) and lse.shape == (b, n, s)
    assert (o.float() - ro.float()).abs().max().item() <= tol
    assert (lse - rlse).abs().max().item() <= 1e-4


def _flash_inputs(device, dtype, b, s, n, d, q_scale=1.0):
    """Strided q/k/v views of a fused QKV tensor, q scaled by ``q_scale``."""
    gen = torch.Generator(device=device).manual_seed(0)
    qkv = torch.randn((b, s, 3, n * d), generator=gen, device=device)
    qkv[:, :, 0] *= q_scale
    qkv = qkv.to(dtype)
    return tuple(qkv[:, :, i].reshape(b, s, n, d) for i in range(3))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_kernels_take_an_empty_shard(cuda_device, dtype):
    """A data rank's empty shard of a pipeline microbatch (batch 0): the
    forward and both backward wrappers return empty tensors and launch no
    grid (a grid of no blocks is a launch error)."""
    q, k, v = (torch.zeros(0, 77, 4, 64, dtype=dtype, device=cuda_device,
                           requires_grad=True) for _ in range(3))
    before = (fa.flash_attention.launches, fa.flash_bwd_dq.launches, fa.flash_bwd_dkv.launches)
    o, lse = fa.flash_attention(q, k, v, 5, dropout_rate=0.1, dropout_seed=7)
    grads = torch.autograd.grad(o.float().sum(), (q, k, v))
    torch.cuda.synchronize()
    assert o.shape == (0, 77, 4, 64) and lse.shape == (0, 4, 77)
    assert all(g.shape == (0, 77, 4, 64) for g in grads)
    assert (fa.flash_attention.launches, fa.flash_bwd_dq.launches,
            fa.flash_bwd_dkv.launches) == before


@pytest.mark.cuda
@pytest.mark.parametrize("d", FLASH_DIMS)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_kernel_repeats_bit_equal(cuda_device, dtype, d):
    """Two forward launches on the same inputs (a prefix across tiles,
    dropout) give the same bits: no atomics, no order that changes."""
    q, k, v = _flash_inputs(cuda_device, dtype, 2, 333, 4, d)
    kw = dict(dropout_rate=0.1, dropout_seed=99)
    o, lse = fa.flash_attention(q, k, v, 40, **kw)
    o2, lse2 = fa.flash_attention(q, k, v, 40, **kw)
    torch.cuda.synchronize()
    assert torch.equal(o, o2) and torch.equal(lse, lse2)


def _backward_inputs(device, dtype, b, s, n, sep, rate, seed=0, d=64):
    """Strided q/k/v of a fused QKV tensor, dO, and the forward kernel's lse
    with delta = rowsum(dO * O)."""
    gen = torch.Generator(device=device).manual_seed(seed)
    qkv = torch.randn((b, s, 3, n * d), generator=gen, device=device).to(dtype)
    q, k, v = (qkv[:, :, i].reshape(b, s, n, d) for i in range(3))
    do = torch.randn((b, s, n, d), generator=gen, device=device).to(dtype)
    kw = dict(dropout_rate=rate, dropout_seed=4321 if rate else None)
    with torch.no_grad():
        o, lse = fa.flash_attention(q, k, v, sep, **kw)
    delta = (do.float() * o.float()).sum(-1).transpose(1, 2).contiguous()
    return (q, k, v, do, lse, delta), kw


def _rel_err(got, want):
    return ((got.float() - want.float()).abs().max() / want.float().abs().max()).item()


@pytest.mark.cuda
@pytest.mark.parametrize("d", FLASH_DIMS)
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4), (torch.bfloat16, 2e-2)])
@pytest.mark.parametrize("s,sep,rate", [(77, 0, 0.0), (77, 64, 0.1), (130, 5, 0.0),
                                        (130, 100, 0.0), (130, 64, 0.1), (1088, 0, 0.1),
                                        (1088, 100, 0.0), (1344, 0, 0.1)])
def test_flash_backward_kernels_match_plain_versions(cuda_device, dtype, tol, s, sep, rate, d):
    """dq (K4) and dk, dv (K5) against their plain versions on strided
    q/k/v: each within ``tol`` of its largest magnitude (bfloat16: ds and pd
    are rounded to bfloat16 before their products, and the outputs once
    more), and two launches on the same inputs bit-equal (no atomics)."""
    args, kw = _backward_inputs(cuda_device, dtype, 2, s, 4, sep, rate, d=d)
    n_dq, n_dkv = fa.flash_bwd_dq.launches, fa.flash_bwd_dkv.launches
    dq = fa.flash_bwd_dq(*args, sep, **kw)
    dk, dv = fa.flash_bwd_dkv(*args, sep, **kw)
    dq2 = fa.flash_bwd_dq(*args, sep, **kw)
    dk2, dv2 = fa.flash_bwd_dkv(*args, sep, **kw)
    torch.cuda.synchronize()
    assert (fa.flash_bwd_dq.launches - n_dq, fa.flash_bwd_dkv.launches - n_dkv) == (2, 2)
    rdq = fa.flash_bwd_dq_reference(*args, sep, kw["dropout_rate"], kw["dropout_seed"])
    rdk, rdv = fa.flash_bwd_dkv_reference(*args, sep, kw["dropout_rate"], kw["dropout_seed"])
    for got, want in ((dq, rdq), (dk, rdk), (dv, rdv)):
        assert got.dtype == dtype and got.shape == (2, s, 4, d)
        assert _rel_err(got, want) <= tol
    assert torch.equal(dq, dq2) and torch.equal(dk, dk2) and torch.equal(dv, dv2)


@pytest.mark.cuda
@pytest.mark.parametrize("d", FLASH_DIMS)
@pytest.mark.parametrize("sep,rate", [(0, 0.0), (40, 0.1)])
def test_flash_grads_match_autograd_of_plain_forward(cuda_device, sep, rate, d):
    """Gradients through the three kernels (forward, dq, dk/dv) against
    autograd of the plain forward, float32, within 1e-4 of the largest."""
    gen = torch.Generator(device=cuda_device).manual_seed(3)
    q, k, v = (torch.randn((2, 200, 3, d), generator=gen, device=cuda_device)
               .requires_grad_() for _ in range(3))
    w = torch.randn((2, 200, 3, d), generator=gen, device=cuda_device)
    kw = dict(dropout_rate=rate, dropout_seed=77 if rate else None)
    o, lse = fa.flash_attention(q, k, v, sep, **kw)
    assert not lse.requires_grad
    got = torch.autograd.grad((o * w).sum(), (q, k, v))
    ro, _ = fa.flash_attention_reference(q, k, v, sep, kw["dropout_rate"], kw["dropout_seed"])
    want = torch.autograd.grad((ro * w).sum(), (q, k, v))
    for g, r in zip(got, want):
        assert _rel_err(g, r) <= 1e-4


@pytest.mark.cuda
@pytest.mark.parametrize("d", [64, 100, 160, 256])
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4), (torch.bfloat16, 2e-2)])
@pytest.mark.parametrize("s,sep", [(130, 5), (1088, 0)])
def test_flash_kernels_with_offsets_match_plain_versions(cuda_device, dtype, tol, s, sep, d):
    """K3, K4 and K5 on a shard (rows 2-3 and heads 2-3 of a batch of 4 x 4
    heads, strided views) with dropout 0.1 and the shard's batch and head
    offsets: each within ``tol`` of its plain version with the same offsets
    and of the unsharded kernels' block; zero offsets are the unsharded
    launch, bit for bit.  Besides D = 64: D = 100 (8-byte copies of its
    200-byte bf16 heads) and the tiles past 128 columns, where two blocks
    each form the whole dropout tile (160, 256)."""
    (q, k, v, do, lse, delta), kw = _backward_inputs(cuda_device, dtype, 4, s, 4, sep, 0.1,
                                                     d=d)
    full_o, full_lse = fa.flash_attention(q, k, v, sep, **kw)
    zero_o, zero_lse = fa.flash_attention(q, k, v, sep, batch_offset=0, head_offset=0,
                                          num_heads=4, **kw)
    assert torch.equal(full_o, zero_o) and torch.equal(full_lse, zero_lse)
    full_dq = fa.flash_bwd_dq(q, k, v, do, lse, delta, sep, **kw)
    full_dk, full_dv = fa.flash_bwd_dkv(q, k, v, do, lse, delta, sep, **kw)
    rows, heads = slice(2, 4), slice(2, 4)
    blk = [t[rows, :, heads] for t in (q, k, v, do)]
    off = (2, 2, 4)
    o, blse = fa.flash_attention(*blk[:3], sep, batch_offset=2, head_offset=2, num_heads=4,
                                 **kw)
    bl, bd = lse[rows, heads].contiguous(), delta[rows, heads].contiguous()
    dq = fa.flash_bwd_dq(*blk, bl, bd, sep, offsets=off, **kw)
    dk, dv = fa.flash_bwd_dkv(*blk, bl, bd, sep, offsets=off, **kw)
    rate, seed = kw["dropout_rate"], kw["dropout_seed"]
    ro, rlse = fa.flash_attention_reference(*blk[:3], sep, rate, seed, off)
    rdq = fa.flash_bwd_dq_reference(*blk, bl, bd, sep, rate, seed, off)
    rdk, rdv = fa.flash_bwd_dkv_reference(*blk, bl, bd, sep, rate, seed, off)
    for got, plain, full in ((o, ro, full_o), (dq, rdq, full_dq), (dk, rdk, full_dk),
                             (dv, rdv, full_dv)):
        assert _rel_err(got, plain) <= tol
        assert _rel_err(got, full[rows, :, heads]) <= tol
    assert (blse - rlse).abs().max().item() <= 1e-4
    assert (blse - full_lse[rows, heads]).abs().max().item() <= 1e-4


@pytest.mark.cuda
def test_flash_kernel_rejects_what_it_does_not_take(cuda_device):
    """A head dim past 256 (wgmma's widest product) and heads that are not
    contiguous are refused by name; operands off a 16-byte boundary are
    taken (test_flash_kernel_takes_unaligned_operands)."""
    q = torch.zeros((1, 8, 2, 264), device=cuda_device)
    with pytest.raises(NotImplementedError, match="head_dim 264"):
        fa.flash_attention(q, q, q)
    q = torch.zeros((1, 8, 64, 2), device=cuda_device).transpose(2, 3)
    with pytest.raises(ValueError, match="contiguous"):
        fa.flash_attention(q, q, q)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,offset", [(torch.float32, 1), (torch.bfloat16, 4),
                                          (torch.bfloat16, 1)])
def test_flash_kernel_takes_unaligned_operands(cuda_device, dtype, offset):
    """Rows ``offset`` elements past a 16-byte boundary (float32 4 bytes;
    bf16 8 and 2 bytes) run with narrower copies, forward and backward,
    within the plain versions' tolerances, without a copy of the operands."""
    gen = torch.Generator(device=cuda_device).manual_seed(9)
    qkv = torch.randn((2, 77, 3 * 4 * 64 + offset), generator=gen, device=cuda_device)
    qkv = qkv.to(dtype).requires_grad_()
    q, k, v = (qkv[:, :, offset + i * 256:offset + (i + 1) * 256].reshape(2, 77, 4, 64)
               for i in range(3))
    tol = 1e-4 if dtype == torch.float32 else 2e-2
    o, lse = fa.flash_attention(q, k, v, 5)
    ro, rlse = fa.flash_attention_reference(q, k, v, 5)
    assert (o.float() - ro.float()).abs().max().item() <= tol
    assert (lse - rlse).abs().max().item() <= 1e-4
    w = torch.randn(o.shape, generator=gen, device=cuda_device).to(dtype)
    got = torch.autograd.grad((o.float() * w.float()).sum(), qkv)[0]
    want = torch.autograd.grad((ro.float() * w.float()).sum(), qkv)[0]
    assert _rel_err(got, want) <= tol


@pytest.mark.cuda
def test_smoke_post_selection_runs_the_flash_kernel(cuda_device):
    """The smoke preset (D = 16) scores 4 sequences of 1058 tokens in bf16
    through the flash kernel, once per layer, and agrees with dense attention
    on the card to 2e-3 of the largest score (the two paths round bf16
    probabilities and contexts at different points)."""
    from cogview_tpu_torch.config import smoke
    from cogview_tpu_torch.generation import scoring
    from cogview_tpu_torch.models import gpt

    cfg = smoke()
    assert cfg.head_dim == 16 and cfg.compute_dtype == torch.bfloat16
    params = gpt.init_params(cfg, torch.Generator(device=cuda_device).manual_seed(0),
                             dtype=torch.bfloat16, device=cuda_device)
    # text ids throughout: the scored tail must lie outside the image vocabulary
    tokens = torch.randint(8192, 8192 + 50000, (4, 1058),
                           generator=torch.Generator().manual_seed(1)).to(cuda_device)
    before = fa.flash_attention.launches
    got = scoring.inverse_prompt_score(params, cfg, tokens)
    torch.cuda.synchronize()
    assert fa.flash_attention.launches - before == cfg.num_layers
    want = scoring.inverse_prompt_score(params, cfg.replace(use_flash_attention=False), tokens)
    assert fa.flash_attention.launches - before == cfg.num_layers
    assert bool(torch.isfinite(got).all()) and got.shape == (4,)
    assert (got - want).abs().max().item() <= 2e-3 * want.abs().max().item()


@pytest.mark.cuda
def test_smoke_pretrain_step_runs_the_flash_kernels(cuda_device):
    """One train step of the smoke preset (D = 16, bf16 compute) on 1088
    tokens: with remat the forward kernel runs twice per layer and each
    backward kernel once; the loss is finite."""
    from cogview_tpu_torch.config import smoke
    from cogview_tpu_torch.models import gpt
    from cogview_tpu_torch.training import optim
    from cogview_tpu_torch.training import train_loop as tl

    cfg = smoke()
    params = gpt.init_params(cfg, torch.Generator(device=cuda_device).manual_seed(0),
                             device=cuda_device)
    opt, _ = optim.make_optimizer(params, lr=1e-3, warmup_iter=1, num_iters=10)
    state = tl.init_train_state(params, opt, torch.Generator().manual_seed(0))
    rng = torch.Generator().manual_seed(2)
    batch = {"text": torch.randint(0, cfg.vocab_size, (2, 1089), generator=rng).to(cuda_device),
             "loss_mask": torch.ones(2, 1089, device=cuda_device)}
    counters = (fa.flash_attention, fa.flash_bwd_dq, fa.flash_bwd_dkv)
    before = [c.launches for c in counters]
    _, metrics = tl.make_train_step(cfg, opt)(state, batch)
    torch.cuda.synchronize()
    L = cfg.num_layers
    assert [c.launches - n for c, n in zip(counters, before)] == [2 * L, L, L]
    assert metrics["skipped"] == 0 and torch.isfinite(torch.tensor(metrics["lm_loss"]))


@pytest.mark.cuda
@pytest.mark.parametrize("route", ["mems", "sparse", "dual positions"])
def test_smoke_pretrain_steps_of_the_other_routes(cuda_device, route):
    """Two train steps of the smoke preset on the card through the memory
    route (the memory grows), the sparse route (64 / 4 / 256 over 1,088
    tokens) and dual positions at 1,344 tokens: finite losses, no skipped
    step; the memory and sparse routes are dense torch (no flash launch),
    dual positions runs the flash kernels as the plain route does."""
    from cogview_tpu_torch.config import smoke
    from cogview_tpu_torch.models import gpt
    from cogview_tpu_torch.training import optim
    from cogview_tpu_torch.training import train_loop as tl

    S = 1345 if route == "dual positions" else 1089
    cfg = smoke(max_position_embeddings=S, query_window=64, key_window_times=4, num_pivot=256)
    params = gpt.init_params(cfg, torch.Generator(device=cuda_device).manual_seed(0),
                             device=cuda_device)
    opt, _ = optim.make_optimizer(params, lr=1e-3, warmup_iter=1, num_iters=10)
    state = tl.init_train_state(params, opt, torch.Generator().manual_seed(0))
    kw = {"mems": dict(max_memory_length=1500), "sparse": dict(is_sparse=True),
          "dual positions": dict(dual_positions_roi2=58200)}[route]
    step = tl.make_train_step(cfg, opt, img_vocab=8192, **kw)
    rng = torch.Generator().manual_seed(2)
    counters = (fa.flash_attention, fa.flash_bwd_dq, fa.flash_bwd_dkv)
    before = [c.launches for c in counters]
    mems = None
    for i in range(2):
        text = torch.randint(0, 8192, (2, S), generator=rng)
        text[:, 1000] = 58200  # [ROI2]
        batch = {"text": text.to(cuda_device), "loss_mask": torch.ones(2, S, device=cuda_device)}
        if route == "mems":
            _, metrics, mems = step(state, batch, mems=mems)
            assert mems.shape == (cfg.num_layers + 1, 2, min(1500, 1088 * (i + 1)), 64)
        else:
            _, metrics = step(state, batch)
        assert metrics["skipped"] == 0 and torch.isfinite(torch.tensor(metrics["lm_loss"]))
    torch.cuda.synchronize()
    L = cfg.num_layers
    want = [4 * L, 2 * L, 2 * L] if route == "dual positions" else [0, 0, 0]
    assert [c.launches - n for c, n in zip(counters, before)] == want


def _decode_cache(device, packed, B, N, D, seed, NW=9):
    """One layer of a random cache of NW windows (9: cogview-base's 1088
    positions): int8 bytes, or packed bytes the packer can make, scales,
    ring and a float32 q."""
    W, G = da.WRITE_WINDOW, da.SEAL_GROUP
    gen = torch.Generator(device=device).manual_seed(seed)
    if packed:
        hi, lo = (torch.randint(-7, 8, (NW, B, 2, N, D // 2, W), generator=gen, device=device)
                  for _ in range(2))
        kv = (16 * hi + lo + 8).to(torch.int8)
        sc = torch.rand((NW, B, 2, N, W), generator=gen, device=device) * 0.3
    else:
        kv = torch.randint(-127, 128, (NW, B, 2, N, D, W), generator=gen, device=device,
                           dtype=torch.int8)
        sc = torch.rand((NW, B, 2, N, W), generator=gen, device=device) * 0.02
    ring = torch.randn((G, B, N, 2 * D), generator=gen, device=device)
    q = torch.randn((B, N, D), generator=gen, device=device)
    return q, ring, kv, sc


def _check_decode(device, packed, dtype, B, N, D, index, seed, splits=None, NW=9):
    """K2 (``packed``) or K1 on one layer, twice from the same cache, and
    the plain version: ctx within the kernel's tolerance (float32 q 1e-4;
    bf16 q: K1 2e-2, as it rounds q and p * vs to bf16; K2 1e-4 + one bf16
    ulp, 2^-7 of the value, as it computes in float32 and rounds its ctx
    once); the cache bit-equal to the plain version's and written on seal
    steps only; the two launches bit-equal, ctx and cache; one launch
    counted per call, on the kernel's own counter."""
    G = da.SEAL_GROUP
    q, ring, kv, sc = _decode_cache(device, packed, B, N, D, seed, NW)
    q = q.to(dtype)
    kv_k, sc_k, kv_2, sc_2, kv_r, sc_r = (t.clone() for t in (kv, sc) * 3)
    n1, n2 = da.decode_attention_quant.launches, da.decode_attention_quant.launches_int4
    ctx = da.decode_attention_quant(q, ring, kv_k, sc_k, index, splits=splits)
    ctx2 = da.decode_attention_quant(q, ring, kv_2, sc_2, index, splits=splits)
    torch.cuda.synchronize()
    assert (da.decode_attention_quant.launches - n1,
            da.decode_attention_quant.launches_int4 - n2) == ((0, 2) if packed else (2, 0))
    want = da.decode_attention_quant_reference(q, ring, kv_r, sc_r, index)
    assert ctx.dtype == dtype and ctx.shape == (B, N, D)
    diff = (ctx.float() - want.float()).abs()
    if dtype == torch.float32:
        assert diff.max().item() <= 1e-4
    elif packed:
        assert bool((diff <= 1e-4 + want.float().abs() * 2.0 ** -7).all())
    else:
        assert diff.max().item() <= 2e-2
    assert torch.equal(kv_k, kv_r) and torch.equal(sc_k, sc_r)
    assert torch.equal(kv_k, kv) == (index % G != G - 1)
    assert torch.equal(ctx, ctx2) and torch.equal(kv_k, kv_2) and torch.equal(sc_k, sc_2)


# c0 = 0 (every sealed column masked, seal into lanes 0-7 at index 7), two
# non-seal steps, a seal on a window boundary (135: c0 = 128) and mid-window
# (1031), a step past the middle (600) and the cache's last slot (1088)
DECODE_INDICES = list(range(8)) + [10, 15, 133, 135, 600, 1031, 1088]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("index", DECODE_INDICES)
def test_decode_kernel_matches_plain_version(cuda_device, dtype, index):
    """K1 at cogview-base head shapes (B=4, N=40, D=64, 9 windows, the
    split plan's 4 splits): see ``_check_decode``."""
    _check_decode(cuda_device, False, dtype, 4, 40, 64, index, seed=1)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("index", DECODE_INDICES)
def test_int4_decode_kernel_matches_plain_version(cuda_device, dtype, index):
    """K2 at cogview-base head shapes: see ``_check_decode``."""
    _check_decode(cuda_device, True, dtype, 4, 40, 64, index, seed=2)


@pytest.mark.cuda
@pytest.mark.parametrize("packed,d", DECODE_CASES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("index", [3, 135, 1031, 1088])
def test_decode_kernels_over_head_dims(cuda_device, packed, dtype, index, d):
    """K1 and K2 at every tile width of the switch and at dims between them
    (odd D = 33: K1 only, its ring slots 8-byte aligned), B=2, N=4 (9
    splits): at D = 8 an int4 block is 512 bytes, 4 rows of 128."""
    _check_decode(cuda_device, packed, dtype, 2, 4, d, index, seed=3)


@pytest.mark.cuda
@pytest.mark.parametrize("batch", [1, 4, 40])
@pytest.mark.parametrize("index", [600, 1031])
@pytest.mark.parametrize("packed", [False, True], ids=["K1", "K2"])
def test_decode_kernels_over_batch(cuda_device, packed, index, batch):
    """bf16 q at cogview-base head shapes and batch 1 (9 splits), 4 (4) and
    40 (one split, no merge)."""
    assert da.split_plan(batch, 40, 9) == {1: 9, 4: 4, 40: 1}[batch]
    _check_decode(cuda_device, packed, torch.bfloat16, batch, 40, 64, index, seed=4)


@pytest.mark.cuda
@pytest.mark.parametrize("index", [1088, 1151, 1300, 1343])
@pytest.mark.parametrize("packed", [False, True], ids=["K1", "K2"])
def test_decode_kernels_on_a_super_resolution_cache(cuda_device, packed, index):
    """Batch 1 over 11 windows, the cache of a magnify window (up to 1,345
    positions), at cogview-base head shapes: the split plan's 11 splits,
    float32 and bf16 q, a seal at 1151 and 1343."""
    assert da.split_plan(1, 40, 11) == 11
    for dtype in (torch.float32, torch.bfloat16):
        _check_decode(cuda_device, packed, dtype, 1, 40, 64, index, seed=6, NW=11)


@pytest.mark.cuda
@pytest.mark.parametrize("splits", range(1, 10))
@pytest.mark.parametrize("packed", [False, True], ids=["K1", "K2"])
def test_decode_kernels_at_every_split_count(cuda_device, packed, splits):
    """Any split count from 1 to the 9 windows gives the same answers: a
    seal mid-window (1031), float32 and bf16 q."""
    for dtype in (torch.float32, torch.bfloat16):
        _check_decode(cuda_device, packed, dtype, 4, 40, 64, 1031, seed=5, splits=splits)


@pytest.mark.cuda
def test_decode_wrapper_rejects_what_the_kernels_do_not_take(cuda_device):
    q, ring, kv, sc = _decode_cache(cuda_device, False, 2, 4, 264, seed=0, NW=1)
    with pytest.raises(NotImplementedError, match="head_dim 264"):  # past the widest tile
        da.decode_attention_quant(q, ring, kv, sc, 20)
    q, ring, kv, sc = _decode_cache(cuda_device, False, 2, 4, 33, seed=0)
    with pytest.raises(ValueError, match="odd head_dim 33"):  # no room in the int4 cache
        da.decode_attention_quant(q, ring, kv[:, :, :, :, :16].contiguous(),
                                  sc, 20)
    q, ring, kv, sc = _decode_cache(cuda_device, False, 2, 4, 64, seed=0)

    def misaligned(t):  # a contiguous view 4 bytes past a 16-byte boundary
        return torch.zeros(t.numel() + 1, device=cuda_device)[1:].view(t.shape).copy_(t)

    with pytest.raises(ValueError, match="aligned"):
        da.decode_attention_quant(q, ring, kv, misaligned(sc), 20)
    with pytest.raises(ValueError, match="aligned"):
        da.decode_attention_quant(q, misaligned(ring), kv, sc, 20)
    for splits in (0, 10):
        with pytest.raises(ValueError, match="splits"):
            da.decode_attention_quant(q, ring, kv, sc, 20, splits=splits)
    with pytest.raises(ValueError, match="ring"):  # the kernels' ring has 8 slots
        da.decode_attention_quant(q, ring[:4].contiguous(), kv, sc, 20)


@pytest.mark.cuda
@pytest.mark.parametrize("kv_cache", ["int4", "bfloat16"])
def test_tiny_decode_card_matches_cpu(cuda_device, kv_cache):
    """A tiny float32 model's prefill + 28 decode steps through the int4
    cache (K2 on the card) and the bfloat16 cache, card against CPU."""
    from cogview_tpu_torch.config import tiny_test
    from cogview_tpu_torch.models import gpt

    cfg = tiny_test(kv_cache_dtype=kv_cache)
    gen = torch.Generator().manual_seed(1)
    params = gpt.init_params(cfg, gen)
    B, S, ctx = 2, 40, 12
    tokens = torch.randint(0, cfg.vocab_size, (B, S), generator=gen)
    pos = torch.arange(S).expand(B, S)
    outs = {}
    for dev in ("cpu", "cuda"):
        p = _tree_to(params, dev)
        cache = gpt.init_cache(cfg, B, S, device=dev)
        tk, ps = tokens.to(dev), pos.to(dev)
        n2 = da.decode_attention_quant.launches_int4
        got = [gpt.forward_with_cache(p, cfg, tk[:, :ctx], ps[:, :ctx], cache, 0)]
        for t in range(ctx, S):
            got.append(gpt.forward_with_cache(p, cfg, tk[:, t:t + 1], ps[:, t:t + 1], cache, t))
        launched = da.decode_attention_quant.launches_int4 - n2
        outs[dev] = torch.cat(got, dim=1).cpu()
        want_launches = (S - ctx) * cfg.num_layers if (dev, kv_cache) == ("cuda", "int4") else 0
        assert launched == want_launches
    assert (outs["cpu"] - outs["cuda"]).abs().max().item() <= 1e-3


@pytest.mark.cuda
def test_add_one_kernel_matches_plain_version(cuda_device):
    x = torch.randn((8, 128), generator=torch.Generator(device=cuda_device).manual_seed(0),
                    device=cuda_device)
    before = probes.add_one.launches
    got = probes.add_one(x)
    torch.cuda.synchronize()
    assert probes.add_one.launches == before + 1
    assert torch.equal(got, probes.add_one_reference(x))


@pytest.mark.cuda
@pytest.mark.parametrize("n,offset", [(1024, 0), (1023, 0), (4097, 0), (1024, 1), (4097, 3)])
def test_add_one_kernel_sizes_and_offset_views(cuda_device, n, offset):
    """n = 1024 (the vector path only), 1023 and 4097 (its scalar tail), and
    views 4 and 12 bytes into their buffer (off a 16-byte boundary: the
    scalar path): bit-equal to x + 1.0."""
    gen = torch.Generator(device=cuda_device).manual_seed(n + offset)
    x = torch.randn(n + offset, generator=gen, device=cuda_device)[offset:]
    assert x.data_ptr() % 16 == 4 * offset % 16
    got = probes.add_one(x)
    torch.cuda.synchronize()
    assert torch.equal(got, x + 1.0)


@pytest.mark.cuda
def test_decode_convention_kernel_matches_plain_version(cuda_device):
    """P1b at cogview-base head widths (3 layers, 2 windows, batch 4) on a
    random cache, every layer view: bit-equal to its plain version."""
    q, ring, kv, sc = launch_probe.convention_inputs(cuda_device, (3, 2, 4, 40, 64, 128), seed=5)
    before = probes.decode_convention.launches
    for li in range(3):
        got = probes.decode_convention(q, ring[li], kv[li], sc[li], 0)
        want = probes.decode_convention_reference(q, ring[li], kv[li], sc[li], 0)
        torch.cuda.synchronize()
        assert got.dtype == torch.bfloat16 and torch.equal(got, want)
        assert not torch.equal(got, q)
    assert probes.decode_convention.launches == before + 3


@pytest.mark.cuda
def test_decode_convention_kernel_at_layers_0_1_47(cuda_device):
    """P1b on a 48-layer cache at cogview-base head widths (1 window, batch
    2), layers 0, 1 and 47: bit-equal; and a q 2 bytes off a 16-byte
    boundary (the kernel's scalar path) too."""
    q, ring, kv, sc = launch_probe.convention_inputs(cuda_device, (48, 1, 2, 40, 64, 128), seed=6)
    buf = torch.empty(q.numel() + 1, dtype=q.dtype, device=cuda_device)
    q_off = buf[1:].view(q.shape)
    q_off.copy_(q)
    assert q_off.is_contiguous() and q_off.data_ptr() % 16 == 2
    for li in (0, 1, 47):
        want = probes.decode_convention_reference(q, ring[li], kv[li], sc[li], 0)
        for qq in (q, q_off):
            got = probes.decode_convention(qq, ring[li], kv[li], sc[li], 0)
            torch.cuda.synchronize()
            assert torch.equal(got, want) and not torch.equal(got, q)


@pytest.mark.cuda
def test_launch_probes_replayed_from_a_cuda_graph_bit_equal(cuda_device):
    """P1a and P1b (layers 0, 1, 2 in turn) captured in one CUDA graph
    through the shared launch path and replayed: bit-equal to their plain
    versions, and again after the inputs change in place."""
    x = torch.randn(4097, device=cuda_device)
    q, ring, kv, sc = launch_probe.convention_inputs(cuda_device, (3, 2, 4, 40, 64, 128), seed=7)

    def step():
        return (probes.add_one(x),
                launch_probe.convention_chain(q, ring, kv, sc, 3))

    def plain():
        return (probes.add_one_reference(x),
                launch_probe.convention_chain(q, ring, kv, sc, 3,
                                              probes.decode_convention_reference))

    graph, out = _timing.capture(step)
    for _ in range(2):
        graph.replay()
        torch.cuda.synchronize()
        assert all(torch.equal(a, b) for a, b in zip(out, plain()))
        x.mul_(-0.5)
        sc.mul_(3.0)


@pytest.mark.cuda
def test_seal_scatter_kernel_matches_plain_version(cuda_device):
    """P2 on the probe's inputs and on random lane0 in [0, 120] with the
    matching one-hot: byte-equal, lane0 read on the device."""
    qc, oh, l0 = seal_scatter_probe.probe_inputs(cuda_device)
    cases = [(qc, oh, l0)]
    rng = torch.Generator().manual_seed(3)
    for lane0 in torch.randint(0, 121, (5,), generator=rng).tolist() + [0, 120]:
        qc_r = torch.randint(-127, 127, qc.shape, generator=rng).float().to(cuda_device)
        cases.append((qc_r, seal_scatter_probe.one_hot(lane0, cuda_device),
                      torch.full((1, 1), lane0, dtype=torch.int32, device=cuda_device)))
    before = probes.seal_scatter.launches
    for qc_c, oh_c, l0_c in cases:
        got = probes.seal_scatter(qc_c, oh_c, l0_c)
        want = probes.seal_scatter_reference(qc_c, oh_c, l0_c)
        torch.cuda.synchronize()
        assert got.dtype == torch.int8 and torch.equal(got, want)
    assert probes.seal_scatter.launches == before + len(cases)


@pytest.mark.cuda
def test_seal_scatter_kernel_at_every_lane0(cuda_device):
    """P2 at every lane0 in [0, 120] on random qc, with the matching one-hot
    and with it permuted within the group: byte-equal to the plain version,
    and two launches bit-equal."""
    G, W = seal_scatter_probe.G, seal_scatter_probe.W
    rng = torch.Generator().manual_seed(4)
    for lane0 in range(W - G + 1):
        qc = torch.randint(-127, 127, (G, 40, 64), generator=rng).float().to(cuda_device)
        l0 = torch.full((1, 1), lane0, dtype=torch.int32, device=cuda_device)
        perm = torch.randperm(G, generator=rng).to(cuda_device)
        for oh in (seal_scatter_probe.one_hot(lane0, cuda_device),
                   seal_scatter_probe.one_hot(lane0, cuda_device)[perm]):
            got, again = probes.seal_scatter(qc, oh, l0), probes.seal_scatter(qc, oh, l0)
            torch.cuda.synchronize()
            assert torch.equal(got, probes.seal_scatter_reference(qc, oh, l0))
            assert torch.equal(got, again)


@pytest.mark.cuda
def test_seal_scatter_kernel_in_a_cuda_graph_after_inputs_change(cuda_device):
    """One P2 call captured in a CUDA graph reads qc, oh and lane0 anew at
    every replay: changed in place, the replay gives the plain version's
    bytes for the new inputs."""
    qc, oh, l0 = seal_scatter_probe.probe_inputs(cuda_device)
    graph, out = _timing.capture(lambda: seal_scatter_probe.scatter_calls(qc, oh, l0, 1))
    graph.replay()
    torch.cuda.synchronize()
    assert torch.equal(out, probes.seal_scatter_reference(qc, oh, l0))
    qc.mul_(-1.0)
    l0.fill_(97)
    oh.copy_(seal_scatter_probe.one_hot(97, cuda_device).flip(0))
    graph.replay()
    torch.cuda.synchronize()
    want = probes.seal_scatter_reference(qc, oh, l0)
    assert torch.count_nonzero(want[:, :, 97:105]) > 0 and torch.equal(out, want)


@pytest.mark.cuda
def test_probe_loops_in_a_cuda_graph_match_eager(cuda_device):
    """A P1a chain and a P2 loop captured in CUDA graphs and replayed give
    the eager loops' results; capture counts each wrapper call once and
    replays count nothing, and ``time_graph`` counts what its replays ran."""
    x0 = torch.zeros((8, 128), device=cuda_device)
    eager = launch_probe.tiny_chain(x0, 20)
    before = probes.add_one.launches
    graph, out = _timing.capture(lambda: launch_probe.tiny_chain(x0, 20))
    graph.replay()
    graph.replay()
    torch.cuda.synchronize()
    assert probes.add_one.launches == before + 20
    assert torch.equal(out, eager) and eager.sum().item() == 1024 * 20
    timed = _timing.time_graph(cuda_device, lambda: launch_probe.tiny_chain(x0, 20), 2,
                               lambda: probes.add_one.launches)
    assert timed["captured"] == 20 and timed["replayed"] == 3 * 20
    assert probes.add_one.launches == before + 40 and torch.equal(timed["out"], eager)

    qc, oh, l0 = seal_scatter_probe.probe_inputs(cuda_device)
    eager = seal_scatter_probe.seal_loop(qc, oh, l0, 5)
    graph, out = _timing.capture(lambda: seal_scatter_probe.seal_loop(qc, oh, l0, 5))
    graph.replay()
    torch.cuda.synchronize()
    assert torch.equal(out, eager)
    # the graph reads lane0 and the one-hot on the device at each replay
    l0.fill_(40)
    oh.copy_(seal_scatter_probe.one_hot(40, cuda_device))
    graph.replay()
    torch.cuda.synchronize()
    assert torch.equal(out, seal_scatter_probe.seal_loop(qc, oh, l0, 5,
                                                         probes.seal_scatter_reference))
    assert not torch.equal(out, eager)


@pytest.mark.cuda
def test_probe_wrappers_reject_what_the_kernels_do_not_take(cuda_device):
    with pytest.raises(ValueError, match="float32"):
        probes.add_one(torch.zeros((8, 128), dtype=torch.float16, device=cuda_device))
    q, ring, kv, sc = launch_probe.convention_inputs(cuda_device, (1, 2, 1, 4, 64, 128), seed=0)
    with pytest.raises(ValueError, match="batch"):
        probes.decode_convention(q, ring[0], kv[0], sc[0], 0)
    q, ring, kv, sc = launch_probe.convention_inputs(cuda_device, (1, 2, 2, 4, 64, 128), seed=0)
    with pytest.raises(ValueError, match="bfloat16"):
        probes.decode_convention(q.float(), ring[0], kv[0], sc[0], 0)
    qc, oh, l0 = seal_scatter_probe.probe_inputs(cuda_device)
    with pytest.raises(ValueError, match="int32"):
        probes.seal_scatter(qc, oh, l0.long())
    with pytest.raises(ValueError, match="seal group"):
        probes.seal_scatter(qc[:4].contiguous(), oh[:4].contiguous(), l0)
    with pytest.raises(ValueError, match="multiple of 16"):
        probes.seal_scatter(qc, oh[:, :120].contiguous(), l0)


def _tree_to(t, device):
    return ({k: _tree_to(v, device) for k, v in t.items()} if isinstance(t, dict)
            else t.to(device))


class _TinyTextTok:
    num_tokens = 64

    def encode(self, s):
        return [ord(c) % 64 for c in s]

    def decode(self, ids):
        return "".join(chr(97 + (i % 26)) for i in ids)


@pytest.mark.cuda
def test_smoke_width_magnify_card_matches_cpu(cuda_device, monkeypatch):
    """The nine magnify windows at the smoke preset's widths (2 layers,
    hidden 64, 4 heads of 16), float32, int8 cache, with a 128-token
    vocabulary: on the card K1 runs once per decode step and layer, and the
    [1, 4096] codes equal the CPU's (plain versions) from the same seeds."""
    import numpy as np

    from cogview_tpu_torch.config import smoke
    from cogview_tpu_torch.generation import magnify
    from cogview_tpu_torch.generation.sampling import SamplingParams, decode_end
    from cogview_tpu_torch.models import gpt
    from cogview_tpu_torch.tokenization.unified import FakeImageTokenizer, UnifiedTokenizer

    cfg = smoke(vocab_size=128, max_position_embeddings=1400, kv_cache_dtype="int8",
                compute_dtype=torch.float32)
    params = gpt.init_params(cfg, torch.Generator().manual_seed(2))
    tok = UnifiedTokenizer(img_tokenizer=FakeImageTokenizer(32), txt_tokenizer=_TinyTextTok())
    codes = np.random.RandomState(0).randint(0, 32, (1, 1024))
    text = tok.parse_query("[ROI1] ab [BASE] [BOI1]")
    steps = []
    fill = magnify.filling_sequence

    def counted(p, c, template, *a, **kw):
        steps.append(decode_end(template) - template.context_length)
        return fill(p, c, template, *a, **kw)

    monkeypatch.setattr(magnify, "filling_sequence", counted)
    out, launched = {}, {}
    for dev in ("cpu", "cuda"):
        n = da.decode_attention_quant.launches
        out[dev] = magnify.magnify(_tree_to(params, dev), cfg, tok, codes, text,
                                   SamplingParams(seed=3), device=torch.device(dev))
        launched[dev] = da.decode_attention_quant.launches - n
    assert len(steps) == 18
    assert launched == {"cpu": 0, "cuda": cfg.num_layers * sum(steps[9:])}
    assert out["cuda"].shape == (1, 4096) and ((out["cuda"] >= 0) & (out["cuda"] < 32)).all()
    np.testing.assert_array_equal(out["cuda"], out["cpu"])
