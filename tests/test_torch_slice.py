"""Port parity for the whole text->image slice, and the port's import guard.

``generate_once`` runs end to end on a tiny model (2 layers, float32, int8
KV cache, 1024 image slots) in both packages: the same tokens and images.
The port derives each chunk's uint32 seed without ``jax.random``; the test
hands it the seeds the JAX package derives, so both draw the same noise."""

import os
import subprocess
import sys

import numpy as np
import torch

import jax

from cogview_tpu.config import tiny_test as jax_tiny
from cogview_tpu.generation import sampling as js
from cogview_tpu.generation import tasks as jtasks
from cogview_tpu.models import gpt as jgpt
from cogview_tpu.models import vqvae as jvq
from cogview_tpu.ops.hash_prng import seed_from_key
from cogview_tpu.tokenization.unified import UnifiedTokenizer
from cogview_tpu.tokenization.vq_tokenizer import JaxVQTokenizer
from cogview_tpu.utils.rng import rbg_key
from cogview_tpu_torch.config import VQVAEConfig, tiny_test
from cogview_tpu_torch.generation import sampling as ts
from cogview_tpu_torch.generation import tasks as ttasks
from cogview_tpu_torch.models.bridge import gpt_params_from_jax, vqvae_params_from_jax
from cogview_tpu_torch.tokenization.vq_tokenizer import TorchVQTokenizer

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SMALL_VQ = dict(channel=16, embed_dim=8, n_embed=32)


class TinyTextTok:
    num_tokens = 64

    def encode(self, s):
        return [ord(c) % 64 for c in s]

    def decode(self, ids):
        return "".join(chr(97 + (i % 26)) for i in ids)


def test_generate_once_text2image_matches_jax(monkeypatch):
    jcfg = jax_tiny(kv_cache_dtype="int8", max_position_embeddings=1088)
    jparams = jgpt.init_params(jax.random.PRNGKey(0), jcfg)
    jvqp = jvq.init_params(jax.random.PRNGKey(1), jvq.VQVAEConfig(**SMALL_VQ))
    jtok = UnifiedTokenizer(img_tokenizer=JaxVQTokenizer(jvqp, jvq.VQVAEConfig(**SMALL_VQ)),
                            txt_tokenizer=TinyTextTok())
    num, mbz, seed = 3, 2, 5
    want = jtasks.generate_once(jparams, jcfg, jtok, "ab cd", "text2image", num=num,
                                max_inference_batch_size=mbz,
                                sampling=js.SamplingParams(top_k=20, seed=seed))

    # the seeds generate_once derives per chunk: split, then rbg_key
    rng, seeds = jax.random.PRNGKey(seed), []
    for _ in range(2):
        rng, sub = jax.random.split(rng)
        seeds.append(int(seed_from_key(rbg_key(sub))))
    monkeypatch.setattr(ttasks, "_chunk_seed", lambda s, i: seeds[i])

    ttok = UnifiedTokenizer(
        img_tokenizer=TorchVQTokenizer(vqvae_params_from_jax(jax.tree.map(np.asarray, jvqp)),
                                       VQVAEConfig(**SMALL_VQ)),
        txt_tokenizer=TinyTextTok())
    got = ttasks.generate_once(gpt_params_from_jax(jax.tree.map(np.asarray, jparams)),
                               tiny_test(max_position_embeddings=1088), ttok, "ab cd",
                               "text2image", num=num, max_inference_batch_size=mbz,
                               sampling=ts.SamplingParams(top_k=20, seed=seed))
    assert got.tokens.shape == want.tokens.shape == (3, 1032)
    np.testing.assert_array_equal(got.tokens, want.tokens)
    assert ((got.tokens[:, 8:] >= 0) & (got.tokens[:, 8:] < 32)).all()
    np.testing.assert_allclose(got.scores, want.scores, atol=1e-4)
    assert len(got.images) == len(want.images) == 3
    for a, b in zip(got.images, want.images):
        assert a.shape == (1, 256, 256, 3)
        np.testing.assert_allclose(a, b, atol=1e-4)
    assert got.texts == want.texts


def test_chunk_seeds_differ_and_are_uint32():
    seeds = {ttasks._chunk_seed(1234, i) for i in range(8)}
    assert len(seeds) == 8 and all(0 <= s < 2 ** 32 for s in seeds)


def test_port_imports_no_jax():
    """The port and every main-path module import without jax; the only
    cogview_tpu code they load is the framework-free tokenization package."""
    code = (
        "import sys\n"
        "import cogview_tpu_torch, cogview_tpu_torch.config, cogview_tpu_torch.cli.generate\n"
        "import cogview_tpu_torch.ops.attention, cogview_tpu_torch.ops.decode_attention\n"
        "import cogview_tpu_torch.ops.hash_prng, cogview_tpu_torch.ops.layernorm\n"
        "import cogview_tpu_torch.ops.precision, cogview_tpu_torch.ops._kernels\n"
        "import cogview_tpu_torch.models.gpt, cogview_tpu_torch.models.vqvae\n"
        "import cogview_tpu_torch.models.bridge, cogview_tpu_torch.generation.tasks\n"
        "import cogview_tpu_torch.generation.sampling, cogview_tpu_torch.utils.png\n"
        "import cogview_tpu_torch.tokenization.vq_tokenizer\n"
        "assert 'jax' not in sys.modules, 'jax was imported'\n"
        "bad = [m for m in sys.modules if m.startswith('cogview_tpu.')\n"
        "       and not m.startswith('cogview_tpu.tokenization')]\n"
        "assert not bad, bad\n"
        "print('ok')\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0 and out.stdout.strip() == "ok", out.stderr


def test_cli_runs_on_cpu_and_writes_pngs(tmp_path):
    """The CLI's text2image path at the smoke preset on the CPU, with a
    stand-in text tokenizer: PNGs of the expected size come out."""
    from cogview_tpu_torch.cli import generate
    from cogview_tpu_torch.utils.png import read_png

    class WordTok:
        num_tokens = 50000

        def encode(self, s):
            return [100 + i for i, _ in enumerate(s.split())]

        def decode(self, ids):
            return " ".join(map(str, ids))

    q = tmp_path / "q.txt"
    q.write_text("w0 w1 w2\n")
    out = tmp_path / "out"
    rc = generate.main(["--preset", "smoke", "--device", "cpu", "--batch-size", "1",
                        "--input-source", str(q), "--output-path", str(out)],
                       txt_tokenizer=WordTok())
    assert rc == 0
    assert read_png(str(out / "0.png")).shape == (256, 256, 3)
