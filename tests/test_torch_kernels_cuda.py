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


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4), (torch.bfloat16, 2e-2)])
@pytest.mark.parametrize("s,sep,rate", [(77, 5, 0.0), (1058, 0, 0.0), (1089, 100, 0.0),
                                        (333, 40, 0.1)])
def test_flash_kernel_matches_plain_version(cuda_device, dtype, tol, s, sep, rate):
    """The flash kernel on strided views of a fused QKV tensor at
    cogview-base head shapes: o within ``tol`` (bfloat16: one rounding of o
    and of the probabilities), lse within 1e-4."""
    b, n, d = 4, 40, 64
    gen = torch.Generator(device=cuda_device).manual_seed(0)
    qkv = torch.randn((b, s, 3, n * d), generator=gen, device=cuda_device).to(dtype)
    q, k, v = (qkv[:, :, i].reshape(b, s, n, d) for i in range(3))
    kw = dict(dropout_rate=rate, dropout_seed=1234 if rate else None)
    before = fa.flash_attention.launches
    o, lse = fa.flash_attention(q, k, v, sep, **kw)
    torch.cuda.synchronize()
    assert fa.flash_attention.launches == before + 1
    ro, rlse = fa.flash_attention_reference(q, k, v, sep, **kw)
    assert o.dtype == dtype and o.shape == (b, s, n, d) and lse.shape == (b, n, s)
    assert (o.float() - ro.float()).abs().max().item() <= tol
    assert (lse - rlse).abs().max().item() <= 1e-4


def _backward_inputs(device, dtype, b, s, n, sep, rate, seed=0):
    """Strided q/k/v of a fused QKV tensor, dO, and the forward kernel's lse
    with delta = rowsum(dO * O)."""
    gen = torch.Generator(device=device).manual_seed(seed)
    qkv = torch.randn((b, s, 3, n * 64), generator=gen, device=device).to(dtype)
    q, k, v = (qkv[:, :, i].reshape(b, s, n, 64) for i in range(3))
    do = torch.randn((b, s, n, 64), generator=gen, device=device).to(dtype)
    kw = dict(dropout_rate=rate, dropout_seed=4321 if rate else None)
    with torch.no_grad():
        o, lse = fa.flash_attention(q, k, v, sep, **kw)
    delta = (do.float() * o.float()).sum(-1).transpose(1, 2).contiguous()
    return (q, k, v, do, lse, delta), kw


def _rel_err(got, want):
    return ((got.float() - want.float()).abs().max() / want.float().abs().max()).item()


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4), (torch.bfloat16, 2e-2)])
@pytest.mark.parametrize("s,sep,rate", [(77, 0, 0.0), (77, 64, 0.1), (130, 5, 0.0),
                                        (130, 100, 0.0), (130, 64, 0.1), (1088, 0, 0.1),
                                        (1088, 100, 0.0)])
def test_flash_backward_kernels_match_plain_versions(cuda_device, dtype, tol, s, sep, rate):
    """dq (K4) and dk, dv (K5) against their plain versions on strided
    q/k/v: each within ``tol`` of its largest magnitude (bfloat16: ds and pd
    are rounded to bfloat16 before their products, and the outputs once
    more), and two launches on the same inputs bit-equal (no atomics)."""
    args, kw = _backward_inputs(cuda_device, dtype, 2, s, 4, sep, rate)
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
        assert got.dtype == dtype and got.shape == (2, s, 4, 64)
        assert _rel_err(got, want) <= tol
    assert torch.equal(dq, dq2) and torch.equal(dk, dk2) and torch.equal(dv, dv2)


@pytest.mark.cuda
@pytest.mark.parametrize("sep,rate", [(0, 0.0), (40, 0.1)])
def test_flash_grads_match_autograd_of_plain_forward(cuda_device, sep, rate):
    """Gradients through the three kernels (forward, dq, dk/dv) against
    autograd of the plain forward, float32, within 1e-4 of the largest."""
    gen = torch.Generator(device=cuda_device).manual_seed(3)
    q, k, v = (torch.randn((2, 200, 3, 64), generator=gen, device=cuda_device)
               .requires_grad_() for _ in range(3))
    w = torch.randn((2, 200, 3, 64), generator=gen, device=cuda_device)
    kw = dict(dropout_rate=rate, dropout_seed=77 if rate else None)
    o, lse = fa.flash_attention(q, k, v, sep, **kw)
    assert not lse.requires_grad
    got = torch.autograd.grad((o * w).sum(), (q, k, v))
    ro, _ = fa.flash_attention_reference(q, k, v, sep, kw["dropout_rate"], kw["dropout_seed"])
    want = torch.autograd.grad((ro * w).sum(), (q, k, v))
    for g, r in zip(got, want):
        assert _rel_err(g, r) <= 1e-4


@pytest.mark.cuda
def test_flash_kernel_rejects_what_it_does_not_take(cuda_device):
    q = torch.zeros((1, 8, 2, 32), device=cuda_device)
    with pytest.raises(NotImplementedError, match="head_dim"):
        fa.flash_attention(q, q, q)
    qkv = torch.zeros((1, 8, 3 * 64 * 2 + 1), device=cuda_device)
    q = qkv[:, :, 1:129].reshape(1, 8, 2, 64)  # rows not 4-element aligned
    with pytest.raises(ValueError, match="aligned"):
        fa.flash_attention(q, q, q)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4), (torch.bfloat16, 2e-2)])
@pytest.mark.parametrize("index", [10, 15, 135, 600])
def test_decode_kernel_matches_plain_version(cuda_device, dtype, tol, index):
    """The decode kernel at cogview-base head shapes: ctx within ``tol``,
    the cache bytes bit-equal after seal and non-seal steps."""
    B, N, D, W, G = 4, 40, 64, da.WRITE_WINDOW, da.SEAL_GROUP
    NW = da.pad_cache_len(1088) // W
    gen = torch.Generator(device=cuda_device).manual_seed(1)
    kv = torch.randint(-127, 128, (NW, B, 2, N, D, W), generator=gen, device=cuda_device,
                       dtype=torch.int8)
    sc = torch.rand((NW, B, 2, N, W), generator=gen, device=cuda_device) * 0.02
    ring = torch.randn((G, B, N, 2 * D), generator=gen, device=cuda_device)
    q = torch.randn((B, N, D), generator=gen, device=cuda_device).to(dtype)
    kv_k, sc_k, kv_r, sc_r = kv.clone(), sc.clone(), kv.clone(), sc.clone()
    before = da.decode_attention_quant.launches
    ctx = da.decode_attention_quant(q, ring, kv_k, sc_k, index)
    torch.cuda.synchronize()
    assert da.decode_attention_quant.launches == before + 1
    want = da.decode_attention_quant_reference(q, ring, kv_r, sc_r, index)
    assert ctx.dtype == dtype and ctx.shape == (B, N, D)
    assert (ctx.float() - want.float()).abs().max().item() <= tol
    assert torch.equal(kv_k, kv_r) and torch.equal(sc_k, sc_r)
    assert torch.equal(kv_k, kv) == (index % G != G - 1)


def _int4_cache(device, B, N, D, NW, seed):
    """Packed bytes the packer can make, scales and ring at cogview-base
    head shapes."""
    W, G = da.WRITE_WINDOW, da.SEAL_GROUP
    gen = torch.Generator(device=device).manual_seed(seed)
    hi = torch.randint(-7, 8, (NW, B, 2, N, D // 2, W), generator=gen, device=device)
    lo = torch.randint(-7, 8, (NW, B, 2, N, D // 2, W), generator=gen, device=device)
    kv = (16 * hi + lo + 8).to(torch.int8)
    sc = torch.rand((NW, B, 2, N, W), generator=gen, device=device) * 0.3
    ring = torch.randn((G, B, N, 2 * D), generator=gen, device=device)
    q = torch.randn((B, N, D), generator=gen, device=device)
    return q, ring, kv, sc


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4), (torch.bfloat16, None)])
@pytest.mark.parametrize("index", [10, 15, 133, 135, 600, 1031])
def test_int4_decode_kernel_matches_plain_version(cuda_device, dtype, tol, index):
    """K2 at cogview-base head shapes (B=4, N=40, D=64, 9 windows): ctx
    within ``tol`` (float32) or, for a bf16 q, within the float32 tolerance
    plus one bf16 ulp, 1e-4 + 2^-7 of the value (K2 computes in float32 and
    rounds its bf16 ctx once, as the plain version does), the cache bit-equal to the plain version's after seal (index 135
    seals with c0 = 128, a window boundary) and non-seal steps, untouched on
    non-seal steps, and two launches bit-equal."""
    B, N, D, G = 4, 40, 64, da.SEAL_GROUP
    NW = da.pad_cache_len(1088) // da.WRITE_WINDOW
    q, ring, kv, sc = _int4_cache(cuda_device, B, N, D, NW, seed=2)
    q = q.to(dtype)
    kv_k, sc_k, kv_r, sc_r = kv.clone(), sc.clone(), kv.clone(), sc.clone()
    n1, n2 = da.decode_attention_quant.launches, da.decode_attention_quant.launches_int4
    ctx = da.decode_attention_quant(q, ring, kv_k, sc_k, index)
    ctx2 = da.decode_attention_quant(q, ring, kv_k.clone(), sc_k.clone(), index)
    torch.cuda.synchronize()
    assert (da.decode_attention_quant.launches - n1,
            da.decode_attention_quant.launches_int4 - n2) == (0, 2)
    want = da.decode_attention_quant_reference(q, ring, kv_r, sc_r, index)
    assert ctx.dtype == dtype and ctx.shape == (B, N, D)
    diff = (ctx.float() - want.float()).abs()
    if tol is None:
        assert bool((diff <= 1e-4 + want.float().abs() * 2.0 ** -7).all())
    else:
        assert diff.max().item() <= tol
    assert torch.equal(kv_k, kv_r) and torch.equal(sc_k, sc_r)
    assert torch.equal(kv_k, kv) == (index % G != G - 1)
    assert torch.equal(ctx, ctx2)


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


def _tree_to(t, device):
    return ({k: _tree_to(v, device) for k, v in t.items()} if isinstance(t, dict)
            else t.to(device))
