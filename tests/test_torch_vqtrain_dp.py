"""The port's data-parallel VQ-VAE training (training/vqvae_train.py and
cli/vqtrain.py under a 'data' mesh) on 2 and 4 gloo CPU processes.

The steps: two ST + EMA, gumbel soft and gumbel hard steps on a global
batch of 8 images of 32 x 32 (VQ channel 16, 32 codes, float32), each rank
on its rows, against the JAX package's step on the whole batch on one
device.  The gumbel noise is the JAX step's global draw, each rank handed
its rows.  Tolerances as tests/test_torch_vqvae_train.py: losses to rtol
1e-4, the encoder and decoder leaves to atol 2 x lr and rtol 1e-4, the EMA
buffers (embed, cluster_size, embed_avg) to rtol 1e-5 and atol 1e-6.
The CLI: two ranks over a folder of PNGs log finite losses, rank 0 alone
writes the summaries and the checkpoint, which equals a one-process run's
to the same tolerances and resumes in one process; an indivisible batch
and ranks on several hosts are refused with the JAX CLI's message."""

import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax

from cogview_tpu.models import vqvae as jvq
from cogview_tpu.training import vqvae_train as jtrain
from cogview_tpu_torch.models.bridge import vqvae_params_from_jax, vqvae_params_to_numpy
from cogview_tpu_torch.parallel.spawn import run_ranks

import torch_parallel_workers as workers

torch.set_num_threads(1)

SMALL = dict(channel=16, embed_dim=8, n_embed=32)
LR = 1e-3
B, SIDE, STEPS = 8, 32, 2
MODES = ("st", "gumbel-soft", "gumbel-hard")
TIMEOUT = 240


@functools.lru_cache(maxsize=None)
def _jax_steps():
    """The JAX steps of every mode on the whole batch -> (torch params,
    batches, noise, temperatures, {mode: (metrics, params)})."""
    # the JAX step donates its state: every mode starts from fresh copies
    p0 = jax.tree.map(np.asarray, jvq.init_params(jax.random.PRNGKey(1),
                                                  jvq.VQVAEConfig(**SMALL)))
    rs = np.random.RandomState(0)
    batches = [rs.randn(B, SIDE, SIDE, 3).astype(np.float32) for _ in range(STEPS)]
    keys = jax.random.split(jax.random.PRNGKey(3), STEPS)
    temps = [max(0.0625, float(np.exp(-0.1 * (i + 1)))) for i in range(STEPS)]
    hw = (SIDE // 8) ** 2  # the latent grid
    noise = [np.array(jax.random.gumbel(k, (B * hw, SMALL["n_embed"]), jnp.float32))
             for k in keys]
    want = {}
    for mode in MODES:
        tx = optax.adam(LR)
        state = jtrain.init_vqvae_train_state(jax.tree.map(jnp.array, p0), tx)
        if mode == "st":
            step = jtrain.make_vqvae_train_step(tx, latent_weight=0.25, decay=0.99)
        else:
            step = jtrain.make_vqvae_gumbel_train_step(tx, kl_weight=0.25,
                                                       hard=mode == "gumbel-hard")
        metrics = []
        for i, batch in enumerate(batches):
            if mode == "st":
                state, m = step(state, jnp.asarray(batch))
            else:
                state, m = step(state, jnp.asarray(batch), keys[i], jnp.float32(temps[i]))
            metrics.append({k: float(v) for k, v in m.items()})
        want[mode] = (metrics, jax.tree.map(np.asarray, state["params"]))
    params = vqvae_params_from_jax(p0, ema=True)
    return params, batches, noise, [np.float32(t).item() for t in temps], want


@pytest.fixture(scope="module")
def port_steps(tmp_path_factory):
    """world -> every mode's steps on that many ranks, one spawn a world."""
    runs = {}

    def get(world):
        if world not in runs:
            tmp = str(tmp_path_factory.mktemp(f"vq{world}"))
            params, batches, noise, temps, _ = _jax_steps()
            torch.save({"params": params, "batches": batches,
                        "noise": [torch.from_numpy(n) for n in noise], "temps": temps,
                        "modes": MODES, "lr": LR}, f"{tmp}/in.pt")
            run_ranks(workers.vq_steps, world, tmp, tmp, timeout=TIMEOUT)
            runs[world] = torch.load(f"{tmp}/out.pt", weights_only=False)
        return runs[world]

    return get


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("world", [2, 4])
def test_dp_vq_steps_match_the_jax_step_on_the_whole_batch(world, mode, port_steps):
    got = port_steps(world)[mode]
    metrics, jparams = _jax_steps()[4][mode]
    assert got["step"] == STEPS
    for i, (g, w) in enumerate(zip(got["metrics"], metrics)):
        assert g.keys() == w.keys()
        for k in w:
            np.testing.assert_allclose(g[k], w[k], rtol=1e-4, err_msg=f"step {i} {k}")
    for part in ("encoder", "decoder"):
        for name, p in jparams[part].items():
            for leaf in ("w", "b"):
                np.testing.assert_allclose(got["params"][part][name][leaf], p[leaf],
                                           atol=2 * LR, rtol=1e-4, err_msg=f"{part}.{name}")
    for k in ("embed", "cluster_size", "embed_avg"):
        np.testing.assert_allclose(got["params"]["quantize"][k], jparams["quantize"][k],
                                   rtol=1e-5, atol=1e-6, err_msg=k)
    if mode != "gumbel-soft":  # the codebook moved by the global statistics
        assert np.abs(jparams["quantize"]["cluster_size"]).max() > 0


def _images(tmp_path, n=8, corrupt=()):
    """``n`` PNGs, those at the positions in ``corrupt`` cut short."""
    from cogview_tpu_torch.utils.png import write_png

    img_dir = tmp_path / "imgs"
    img_dir.mkdir()
    rng = np.random.RandomState(0)
    for i in range(n):
        path = img_dir / f"{i:02d}.png"
        write_png(str(path), rng.randint(0, 255, (20, 24, 3), np.uint8))
        if i in corrupt:
            path.write_bytes(path.read_bytes()[:100])
    return img_dir


def _argv(img_dir, save, *extra):
    return ["--data", str(img_dir), "--img-size", "16", "--batch-size", "4",
            "--train-iters", "3", "--channel", "8", "--embed-dim", "8", "--n-embed", "16",
            "--save", str(save), "--save-interval", "3", "--log-interval", "1",
            "--device", "cpu", *extra]


@pytest.mark.parametrize("corrupt", [(), (1, 6)])
def test_vqtrain_cli_on_two_ranks_saves_once_and_resumes_in_one(tmp_path, monkeypatch,
                                                                corrupt):
    """Two ranks (ST + EMA) log finite losses; rank 0 alone writes the
    summaries and the checkpoint; its leaves equal a one-process run's, and
    it resumes in one process.  Each rank decodes its own rows, and with
    undecodable files among the images (one in rank 0's rows of the first
    batch) the ranks still cut the one process's batches."""
    import json

    from cogview_tpu_torch.cli import vqtrain
    from cogview_tpu_torch.preprocess import raw_datasets
    from cogview_tpu_torch.training import vqvae_train as vt
    from cogview_tpu_torch.training.checkpointing import load_latest

    img_dir = _images(tmp_path, corrupt=corrupt)
    two, one = tmp_path / "two", tmp_path / "one"
    torch.save({"argv": _argv(img_dir, two, "--summary-dir", str(tmp_path / "logs"))},
               tmp_path / "in.pt")
    run_ranks(workers.vqtrain_cli, 2, str(tmp_path), str(tmp_path), timeout=TIMEOUT)
    assert (tmp_path / "saved-by-0").exists() and not (tmp_path / "saved-by-1").exists()
    lines = [json.loads(x) for x in
             (tmp_path / "logs" / "vqtrain.metrics.jsonl").read_text().splitlines()]
    assert len(lines) == 3 and all(np.isfinite(x["loss"]) for x in lines)
    decodes, decode = [], raw_datasets.decode_image
    monkeypatch.setattr(raw_datasets, "decode_image", lambda b: decodes.append(1) or decode(b))
    assert vqtrain.main(_argv(img_dir, one)) == 0
    per_rank = [int((tmp_path / f"decodes-{r}").read_text()) for r in range(2)]
    assert max(per_rank) <= 0.75 * len(decodes), (per_rank, len(decodes))
    a, b = load_latest(str(two)), load_latest(str(one))
    assert a["step"] == b["step"] == 3
    pa, pb = vqvae_params_to_numpy(a["params"]), vqvae_params_to_numpy(b["params"])
    for part in ("encoder", "decoder"):
        for name in pb[part]:
            for leaf in ("w", "b"):
                np.testing.assert_allclose(pa[part][name][leaf], pb[part][name][leaf],
                                           atol=2e-3, rtol=1e-4, err_msg=f"{part}.{name}")
    for k in ("embed", "cluster_size", "embed_avg"):
        np.testing.assert_allclose(pa["quantize"][k], pb["quantize"][k], rtol=1e-5,
                                   atol=1e-6, err_msg=k)
    # the two-rank checkpoint takes a one-process step from its own Adam state
    state = dict(a)
    m = vt.make_vqvae_train_step(vt.make_adam(a["params"], 3e-4))(state, torch.from_numpy(
        np.random.RandomState(1).randn(4, 16, 16, 3).astype(np.float32)))
    assert state["step"] == 4 and state["opt_state"]["count"] == 4
    assert np.isfinite(float(m["loss"]))


@pytest.mark.parametrize("env,msg", [
    (dict(WORLD_SIZE="4", RANK="0"), "--batch-size 6 must be divisible by the 4-device data axis"),
    (dict(WORLD_SIZE="2", RANK="0", LOCAL_WORLD_SIZE="1"), "no --multihost"),
])
def test_vqtrain_cli_refuses_an_indivisible_batch_and_several_hosts(tmp_path, monkeypatch,
                                                                    env, msg):
    """The JAX CLI's message for a batch the data axis does not divide, and
    a refusal of ranks on several hosts; both before any group is joined."""
    from cogview_tpu_torch.cli import vqtrain

    for k, v in env.items():
        monkeypatch.setenv(k, v)
    batch = "6" if env["WORLD_SIZE"] == "4" else "4"
    with pytest.raises(SystemExit, match=msg):
        vqtrain.main(["--data", str(tmp_path), "--batch-size", batch, "--device", "cpu"])
    assert not torch.distributed.is_initialized()
