"""Port parity: the VQ-VAE's training half and its train steps against
cogview_tpu (quantize_st, quantize_gumbel, the EMA codebook, the ST + EMA
and gumbel train steps, and the bfloat16 encode), float32 on the CPU.

Tolerances: codes equal; the commitment term, ``apply_ema`` and the EMA
buffers after three steps to rtol 1e-5; losses to rtol 1e-4; parameters
after three Adam steps to atol 2 x lr and rtol 1e-4 (Adam turns a
near-zero gradient into an update of up to lr); a bfloat16 encode flips
fewer than 5% of float32's codes, the JAX test's own bound.  The gumbel
noise of ``jax.random.gumbel`` is handed to the port as ``noise=``.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax

from cogview_tpu.models import vqvae as jvq
from cogview_tpu.training import vqvae_train as jtrain
from cogview_tpu_torch.models import vqvae
from cogview_tpu_torch.models.bridge import vqvae_params_from_jax, vqvae_params_to_numpy
from cogview_tpu_torch.training import vqvae_train

torch.set_num_threads(1)

SMALL = dict(channel=16, embed_dim=8, n_embed=32)
LR = 1e-3


def _jparams(seed=0):
    return jvq.init_params(jax.random.PRNGKey(seed), jvq.VQVAEConfig(**SMALL))


def _both(seed=0):
    jp = _jparams(seed)
    return jp, vqvae_params_from_jax(jax.tree.map(np.asarray, jp), ema=True)


def _z(seed, n=2, side=4):
    return np.random.RandomState(seed).randn(n, side, side, SMALL["embed_dim"]).astype(np.float32)


def _images(seed, n=2, side=32):
    return np.random.RandomState(seed).randn(n, side, side, 3).astype(np.float32)


def test_quantize_st_codes_and_commitment():
    jp, tp = _both()
    z = _z(1)
    jq, jc, jd, _ = jvq.quantize_st(jp, jnp.asarray(z))
    tq, tc, td, _ = vqvae.quantize_st(tp, torch.from_numpy(z))
    np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))
    np.testing.assert_allclose(float(td), float(jd), rtol=1e-5)
    np.testing.assert_allclose(tq.numpy(), np.asarray(jq), atol=1e-6)


def test_quantize_st_straight_through_gradients():
    """d/dz of sum(quant * w) + commitment: the straight-through identity
    plus 2 (z - quant) / n, equal to jax.grad's."""
    jp, tp = _both()
    z = _z(2)
    w = np.random.RandomState(3).randn(*z.shape).astype(np.float32)

    def jloss(z_):
        q, _, d, _ = jvq.quantize_st(jp, z_)
        return jnp.sum(q * w) + d

    want = np.asarray(jax.grad(jloss)(jnp.asarray(z)))
    zt = torch.from_numpy(z).requires_grad_(True)
    q, _, d, _ = vqvae.quantize_st(tp, zt)
    (got,) = torch.autograd.grad(torch.sum(q * torch.from_numpy(w)) + d, zt)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-7)


@pytest.mark.parametrize("hard", [False, True])
def test_quantize_gumbel_given_the_jax_noise(hard):
    jp, tp = _both()
    z = _z(4)
    key = jax.random.PRNGKey(5)
    jq, jkl, jc = jvq.quantize_gumbel(jp, jnp.asarray(z), key, temperature=0.7, hard=hard)
    noise = np.array(jax.random.gumbel(key, (z.size // z.shape[-1], SMALL["n_embed"]),
                                         jnp.float32))
    tq, tkl, tc = vqvae.quantize_gumbel(tp, torch.from_numpy(z), temperature=0.7, hard=hard,
                                        noise=torch.from_numpy(noise))
    np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))
    np.testing.assert_allclose(float(tkl), float(jkl), rtol=1e-5)
    np.testing.assert_allclose(tq.numpy(), np.asarray(jq), rtol=1e-5, atol=1e-6)


def test_gumbel_noise_is_standard_gumbel():
    g = vqvae.gumbel_noise((20000,), torch.Generator().manual_seed(0))
    assert torch.isfinite(g).all()
    assert abs(float(g.mean()) - 0.5772) < 0.03 and abs(float(g.var()) - 1.6449) < 0.08


def test_codebook_stats_and_apply_ema():
    jp, tp = _both()
    z = _z(6, n=3)
    codes = np.random.RandomState(7).randint(0, SMALL["n_embed"], z.shape[:-1])
    js, je = jvq.codebook_stats(jnp.asarray(z), jnp.asarray(codes), SMALL["n_embed"])
    ts, te = vqvae.codebook_stats(torch.from_numpy(z), torch.from_numpy(codes), SMALL["n_embed"])
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), rtol=1e-5)
    np.testing.assert_allclose(te.numpy(), np.asarray(je), rtol=1e-5, atol=1e-6)
    jq = jvq.apply_ema(jp["quantize"], js, je, decay=0.9)
    tq = vqvae.apply_ema(tp["quantize"], ts, te, decay=0.9)
    for k in ("embed", "cluster_size", "embed_avg"):
        np.testing.assert_allclose(tq[k].numpy(), np.asarray(jq[k]), rtol=1e-5, atol=1e-7)


def _compare_params(tparams, jparams):
    got = vqvae_params_to_numpy(tparams)
    for part in ("encoder", "decoder"):
        for name, p in jparams[part].items():
            for leaf in ("w", "b"):
                np.testing.assert_allclose(got[part][name][leaf], np.asarray(p[leaf]),
                                           atol=2 * LR, rtol=1e-4, err_msg=f"{part}.{name}")
    for k in ("embed", "cluster_size", "embed_avg"):
        np.testing.assert_allclose(got["quantize"][k], np.asarray(jparams["quantize"][k]),
                                   rtol=1e-5, atol=1e-6, err_msg=k)


def test_st_ema_train_steps_match_jax():
    """Three ST + EMA steps at VQ channel 16, 32 codes, 32 x 32 images."""
    jp, tp = _both(1)
    tx = optax.adam(LR)
    jstate = jtrain.init_vqvae_train_state(jp, tx)
    jstep = jtrain.make_vqvae_train_step(tx, latent_weight=0.25, decay=0.99)
    ttx = vqvae_train.make_adam(tp, LR)
    tstate = vqvae_train.init_vqvae_train_state(tp, ttx)
    tstep = vqvae_train.make_vqvae_train_step(ttx, latent_weight=0.25, decay=0.99)
    for i in range(3):
        batch = _images(10 + i)
        jstate, jm = jstep(jstate, jnp.asarray(batch))
        tm = tstep(tstate, torch.from_numpy(batch))
        for k in ("loss", "recon_mse", "commit", "codebook_usage"):
            np.testing.assert_allclose(float(tm[k]), float(jm[k]), rtol=1e-4, err_msg=k)
    assert tstate["step"] == 3 and tstate["opt_state"]["count"] == 3
    _compare_params(tstate["params"], jstate["params"])


@pytest.mark.parametrize("hard", [False, True])
def test_gumbel_train_steps_match_jax(hard):
    """Three gumbel steps, soft and hard (EMA in hard mode), the
    temperature annealed as the CLI does, the JAX step's noise handed over."""
    jp, tp = _both(2)
    tx = optax.adam(LR)
    jstate = jtrain.init_vqvae_train_state(jp, tx)
    jstep = jtrain.make_vqvae_gumbel_train_step(tx, kl_weight=0.25, hard=hard)
    ttx = vqvae_train.make_adam(tp, LR)
    tstate = vqvae_train.init_vqvae_train_state(tp, ttx)
    tstep = vqvae_train.make_vqvae_gumbel_train_step(ttx, kl_weight=0.25, hard=hard)
    rng = jax.random.PRNGKey(3)
    for it in range(1, 4):
        batch = _images(20 + it)
        rng, sub = jax.random.split(rng)
        temp = max(0.0625, 1.0 * float(np.exp(-0.1 * it)))
        jstate, jm = jstep(jstate, jnp.asarray(batch), sub, jnp.float32(temp))
        noise = np.array(jax.random.gumbel(sub, (2 * 4 * 4, SMALL["n_embed"]), jnp.float32))
        tm = tstep(tstate, torch.from_numpy(batch), temperature=np.float32(temp).item(),
                   noise=torch.from_numpy(noise))
        for k in ("loss", "recon_mse", "kl"):
            np.testing.assert_allclose(float(tm[k]), float(jm[k]), rtol=1e-4, err_msg=k)
    _compare_params(tstate["params"], jstate["params"])
    moved = not np.array_equal(tstate["params"]["quantize"]["cluster_size"].numpy(),
                               np.zeros(SMALL["n_embed"], np.float32))
    assert moved == hard


def test_bf16_encode_mostly_agrees():
    """img2code(dtype=bfloat16) flips fewer than 5% of float32's codes."""
    jp, tp = _both(3)
    img = _images(30, n=4, side=64)
    f32 = vqvae.img2code(tp, torch.from_numpy(img))
    bf = vqvae.img2code(tp, torch.from_numpy(img), dtype=torch.bfloat16)
    assert bf.shape == f32.shape == (4, 64)
    assert float((bf != f32).float().mean()) < 0.05
    np.testing.assert_array_equal(f32.numpy(), np.asarray(jvq.img2code(jp, img)))


def test_bf16_decode_close_to_float32():
    """code2img(dtype=bfloat16) within 5e-2 of float32 (bf16 carries about
    three decimal digits; the JAX package's bound on its 0..1 images)."""
    jp, tp = _both(4)
    codes = np.random.RandomState(5).randint(0, 32, (2, 16))
    f32 = vqvae.code2img(tp, torch.from_numpy(codes))
    bf = vqvae.code2img(tp, torch.from_numpy(codes), dtype=torch.bfloat16)
    want = np.asarray(jvq.code2img(jp, codes, dtype=jnp.bfloat16))
    assert bf.dtype == torch.float32 and bf.shape == (2, 32, 32, 3)
    np.testing.assert_allclose(bf.numpy(), f32.numpy(), atol=5e-2)
    np.testing.assert_allclose(bf.numpy(), want, atol=5e-2)


@pytest.mark.parametrize("mode", [[], ["--gumbel", "--gumbel-hard"], ["--gumbel"]],
                         ids=["st-ema", "gumbel-hard", "gumbel-soft"])
def test_vqtrain_cli_end_to_end(tmp_path, mode):
    """cli/vqtrain on the CPU over a folder of PNGs: 4 iterations, a
    checkpoint at the last, metrics JSONL, finite losses; the EMA buffers
    move in the modes that update the codebook."""
    from cogview_tpu_torch.cli import vqtrain
    from cogview_tpu_torch.training.checkpointing import load_latest
    from cogview_tpu_torch.utils.png import write_png

    img_dir = tmp_path / "imgs"
    img_dir.mkdir()
    rng = np.random.RandomState(0)
    for i in range(6):
        write_png(str(img_dir / f"{i}.png"), rng.randint(0, 255, (20, 24, 3), np.uint8))
    save = tmp_path / "ckpt"
    assert vqtrain.main(["--data", str(img_dir), "--img-size", "16", "--batch-size", "4",
                         "--train-iters", "4", "--channel", "8", "--embed-dim", "8",
                         "--n-embed", "16", "--save", str(save), "--save-interval", "4",
                         "--log-interval", "2", "--summary-dir", str(tmp_path / "logs"),
                         "--device", "cpu", *mode]) == 0
    last = vqtrain.main.last
    assert last["iteration"] == 4 and np.isfinite(last["loss"]) and last["ms_per_iter"] > 0
    state = load_latest(str(save))
    assert state["step"] == 4 and state["opt_state"]["count"] == 4
    moved = bool((state["params"]["quantize"]["cluster_size"] != 0).any())
    assert moved == (mode != ["--gumbel"])
    assert (tmp_path / "logs" / "vqtrain.metrics.jsonl").exists()


def test_vqtrain_cli_needs_a_card_or_device_cpu(tmp_path):
    from cogview_tpu_torch.cli import vqtrain

    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(SystemExit, match="cuda"):
        vqtrain.main(["--data", str(tmp_path)])
