"""Port parity: the InceptionV3 extractor (cogview_tpu_torch/eval_utils/
inception.py) against cogview_tpu/eval_utils/inception.py, float32 on the
CPU, on the same weights (the JAX package's random init carried across by
``state_dict_from_jax_params``).

Tolerances: each block and the primitives to atol 1e-4 on random input;
pool3 of the whole network at 75 x 75 (the smallest input both accept,
no resize) to atol 1e-4 relative to its scale; the converters bit-equal.
The 299-pixel whole network is the one ``slow`` case.
"""

import numpy as np
import pytest
import torch
import torch.nn.functional as F

import jax
import jax.numpy as jnp

from cogview_tpu.eval_utils import inception as jinc
from cogview_tpu_torch.eval_utils import inception

torch.set_num_threads(1)


def _numpy_params(seed=0):
    """Random params in the JAX package's tree (``_arch()``), drawn with
    numpy (its own ``init_params`` takes about 25 s on this CPU): He-scaled
    normal convs, BN statistics away from the identity, an fc head."""
    rng = np.random.RandomState(seed)

    def conv(shape):
        kh, kw, cin, cout = shape
        return {"w": (rng.randn(kh, kw, cin, cout) * np.sqrt(2.0 / (kh * kw * cin))
                      ).astype(np.float32),
                "bn": {"scale": (1 + 0.1 * rng.randn(cout)).astype(np.float32),
                       "bias": (0.1 * rng.randn(cout)).astype(np.float32),
                       "mean": (0.05 * rng.randn(cout)).astype(np.float32),
                       "var": (np.abs(rng.randn(cout)) + 0.5).astype(np.float32)}}

    params = {}
    for mod, convs in jinc._arch().items():
        params[mod] = (conv(convs[""]) if list(convs) == [""]
                       else {name: conv(shape) for name, shape in convs.items()})
    params["fc"] = {"w": (rng.randn(2048, 1000) * 0.01).astype(np.float32),
                    "b": (0.01 * rng.randn(1000)).astype(np.float32)}
    return params


@pytest.fixture(scope="module")
def both():
    np_params = _numpy_params()
    model = inception.InceptionV3()
    inception.load_torchvision_state_dict(model, inception.state_dict_from_jax_params(np_params))
    return jax.tree.map(jnp.asarray, np_params), model


def _x(seed, shape):
    return np.random.RandomState(seed).rand(*shape).astype(np.float32)


def _nchw(a):
    return torch.from_numpy(a).permute(0, 3, 1, 2)


def _nhwc(t):
    return t.permute(0, 2, 3, 1).detach().numpy()


@pytest.mark.parametrize("align_corners", [True, False])
@pytest.mark.parametrize("hw,size", [((16, 16), 29), ((13, 21), 299), ((40, 40), 17)])
def test_bilinear_resize(align_corners, hw, size):
    """Both align_corners paths equal the JAX matmul form and torch's
    F.interpolate."""
    x = _x(1, (2, *hw, 3))
    got = inception.bilinear_resize(torch.from_numpy(x), size, align_corners).numpy()
    np.testing.assert_allclose(got, np.asarray(jinc.bilinear_resize(x, size, align_corners)),
                               atol=1e-5)
    want = F.interpolate(_nchw(x), size=(size, size), mode="bilinear",
                         align_corners=align_corners)
    np.testing.assert_allclose(got, _nhwc(want), atol=1e-5)


def test_pools_count_the_padding():
    x = _x(2, (1, 7, 9, 4))
    got = _nhwc(inception._avg_pool(_nchw(x)))
    np.testing.assert_allclose(got, np.asarray(jinc._avg_pool_3x3_s1_p1(x)), atol=1e-6)
    assert abs(got[0, 0, 0, 0] - x[0, :2, :2, 0].sum() / 9.0) < 1e-6  # divisor 9 at a corner
    np.testing.assert_allclose(_nhwc(inception._max_pool(_nchw(x))),
                               np.asarray(jinc._max_pool_3x3_s2(x)), atol=0)


def test_basic_conv_bn_eps_and_asymmetric_padding(both):
    """BasicConv2d (BN eps 1e-3 on running statistics) at the 1x7 / 7x1
    paddings, against _conv_bn_relu."""
    jp, model = both
    x = _x(3, (2, 9, 11, 160))
    for name, pad in (("branch7x7dbl_2", jinc.P_7x1), ("branch7x7dbl_3", jinc.P_1x7)):
        want = jinc._conv_bn_relu(x, jp["Mixed_6c"][name], padding=pad)
        got = _nhwc(getattr(model.Mixed_6c, name)(_nchw(x)))
        assert got.shape == want.shape
        np.testing.assert_allclose(got, np.asarray(want), atol=1e-4)
    assert model.Mixed_6c.branch7x7dbl_2.bn.eps == 1e-3


BLOCKS = [("Mixed_5b", jinc._inception_a, 192, 9), ("Mixed_5d", jinc._inception_a, 288, 9),
          ("Mixed_6a", jinc._inception_b, 288, 9), ("Mixed_6b", jinc._inception_c, 768, 7),
          ("Mixed_6e", jinc._inception_c, 768, 5), ("Mixed_7a", jinc._inception_d, 768, 7),
          ("Mixed_7b", jinc._inception_e, 1280, 3), ("Mixed_7c", jinc._inception_e, 2048, 3)]


@pytest.mark.parametrize("name,fn,cin,side", BLOCKS, ids=[b[0] for b in BLOCKS])
def test_mixed_block(both, name, fn, cin, side):
    jp, model = both
    x = _x(4, (1, side, side + 1, cin))
    want = np.asarray(fn(x, jp[name]))
    got = _nhwc(getattr(model, name)(_nchw(x)))
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=1e-4)


def test_stem_blocks_0_to_2(both):
    """features' blocks 0, 1, 2 at 51 x 51 with renormalization, no resize."""
    jp, model = both
    x = _x(5, (1, 51, 51, 3))
    want = jinc.features(jp, x, (0, 1, 2), resize_input=False)
    got = inception.features(model, torch.from_numpy(x), (0, 1, 2), resize_input=False)
    for g, w in zip(got, want):
        assert g.shape == w.shape
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-4)


def test_pool3_and_logits_at_the_smallest_input(both):
    """pool3 of the whole network at 75 x 75 (no resize, renormalized);
    the IS logits on the same image in (-1, 1), not renormalized."""
    jp, model = both
    x = _x(6, (2, 75, 75, 3))
    want = np.asarray(jinc.features(jp, x, (3,), resize_input=False)[0])
    got = inception.features(model, torch.from_numpy(x), (3,), resize_input=False)[0].numpy()
    assert got.shape == want.shape == (2, 2048)
    np.testing.assert_allclose(got, want, atol=1e-4 * max(1.0, np.abs(want).max()))
    want = np.asarray(jinc.logits(jp, x * 2 - 1))
    got = inception.logits(model, torch.from_numpy(x * 2 - 1)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-4 * max(1.0, np.abs(want).max()))


def test_jax_params_round_trip(both):
    """JAX params -> the port's module -> its state dict -> the JAX
    converter: every leaf bit-equal."""
    jp, model = both
    back = jinc.params_from_torch_state_dict(model.state_dict())
    for (pa, a), (pb, b) in zip(jax.tree_util.tree_leaves_with_path(jp),
                                jax.tree_util.tree_leaves_with_path(back)):
        assert pa == pb
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_torchvision_state_dict_round_trip(both, tmp_path):
    """A torchvision-layout file (num_batches_tracked, AuxLogits.* keys,
    an {'state_dict': ...} wrapper) loads with AuxLogits ignored; its
    tensors come back bit-equal; a missing key raises."""
    _, model = both
    sd = {k: v.clone() for k, v in model.state_dict().items()}
    sd["AuxLogits.conv0.conv.weight"] = torch.zeros(128, 768, 1, 1)
    sd["AuxLogits.fc.weight"] = torch.zeros(1000, 768)
    path = tmp_path / "inception_v3.pth"
    torch.save({"state_dict": sd}, path)
    loaded = inception.load_model(str(path))
    assert not loaded.training
    for k, v in loaded.state_dict().items():
        torch.testing.assert_close(v, sd[k], rtol=0, atol=0)
    no_fc = inception.InceptionV3(with_fc=False)
    inception.load_torchvision_state_dict(no_fc, sd)
    assert no_fc.fc is None
    del sd["Mixed_7c.branch_pool.conv.weight"]
    with pytest.raises(ValueError, match="missing"):
        inception.load_torchvision_state_dict(inception.InceptionV3(), sd)


def test_seeded_init_is_deterministic_and_alive():
    """The port's random init: same seed, same weights; pool3 of a random
    input is finite and not collapsed (He gain)."""
    a, b = inception.init_model(0, with_fc=False), inception.init_model(0, with_fc=False)
    for (ka, va), (kb, vb) in zip(a.state_dict().items(), b.state_dict().items()):
        assert ka == kb and torch.equal(va, vb)
    f = inception.features(a, torch.from_numpy(_x(7, (2, 75, 75, 3))), resize_input=False)[0]
    assert torch.isfinite(f).all() and float(f.std()) > 1e-3


@pytest.mark.slow
def test_pool3_at_299(both):
    """The whole network at 299 x 299 from a 64 x 64 input (the resize)."""
    jp, model = both
    x = _x(8, (2, 64, 64, 3))
    want = np.asarray(jinc.pool3_features(jp, x))
    got = inception.pool3_features(model, torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-4 * max(1.0, np.abs(want).max()))
