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
