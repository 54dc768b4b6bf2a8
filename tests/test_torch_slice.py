"""Port parity for the whole text->image slice, and the port's import guard.

``generate_once`` runs end to end on a tiny model (2 layers, float32, int8
KV cache, 1024 image slots) in both packages: the same tokens and images.
The port derives each chunk's uint32 seed without ``jax.random``; the test
hands it the seeds the JAX package derives, so both draw the same noise."""

import ast
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
                               tiny_test(max_position_embeddings=1088, kv_cache_dtype="int8"),
                               ttok, "ab cd",
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
    """Every module of the port, its CLIs included, imports without jax and
    without loading any module of cogview_tpu, Pillow (PIL) or ml_dtypes
    (neither is installed where the port runs on the card); chip_smoke.py
    imports nothing of cogview_tpu either (checked on its syntax tree)."""
    import pkgutil

    import cogview_tpu_torch

    mods = sorted(m.name for m in pkgutil.walk_packages(cogview_tpu_torch.__path__,
                                                        "cogview_tpu_torch."))
    assert {"cogview_tpu_torch.cli.generate", "cogview_tpu_torch.cli.serve",
            "cogview_tpu_torch.cli.pretrain", "cogview_tpu_torch.tokenization.unified",
            "cogview_tpu_torch.data.loader", "cogview_tpu_torch.data.lmdb_io",
            "cogview_tpu_torch.ops.probes", "cogview_tpu_torch.scripts.launch_probe",
            "cogview_tpu_torch.generation.magnify",
            "cogview_tpu_torch.models.convert", "cogview_tpu_torch.models.hf_import",
            "cogview_tpu_torch.utils.jpeg", "cogview_tpu_torch.utils.png",
            "cogview_tpu_torch.scripts.seal_scatter_probe",
            "cogview_tpu_torch.scripts.decode_kernel_microbench",
            "cogview_tpu_torch.ops.sparse_attention", "cogview_tpu_torch.data.position_ids",
            "cogview_tpu_torch.scripts.train_step_profile",
            "cogview_tpu_torch.cli.vqtrain", "cogview_tpu_torch.cli.fid",
            "cogview_tpu_torch.cli.preprocess", "cogview_tpu_torch.training.vqvae_train",
            "cogview_tpu_torch.utils.memory", "cogview_tpu_torch.utils.bmp",
            "cogview_tpu_torch.utils.gif", "cogview_tpu_torch.utils.image_errors",
            "cogview_tpu_torch.preprocess.raw_datasets",
            "cogview_tpu_torch.preprocess.rar_reader",
            "cogview_tpu_torch.preprocess.tokenize_images",
            "cogview_tpu_torch.preprocess.recover_grid",
            "cogview_tpu_torch.eval_utils.inception", "cogview_tpu_torch.eval_utils.fid",
            "cogview_tpu_torch.eval_utils.inception_score",
            "cogview_tpu_torch.eval_utils.dataset",
            "cogview_tpu_torch.parallel.mesh", "cogview_tpu_torch.parallel.comm",
            "cogview_tpu_torch.parallel.sharding", "cogview_tpu_torch.parallel.spawn",
            "cogview_tpu_torch.dryrun", "cogview_tpu_torch.tokenization.sp_cpp",
            "cogview_tpu_torch.data.native_loader", "cogview_tpu_torch.utils.pnm",
            "cogview_tpu_torch.utils.qoi", "cogview_tpu_torch.utils.webp",
            "cogview_tpu_torch.ops.ring_attention",
            "cogview_tpu_torch.parallel.pipeline"} <= set(mods)
    code = (
        "import importlib, sys\n"
        f"for m in {mods!r}:\n"
        "    importlib.import_module(m)\n"
        "assert 'jax' not in sys.modules, 'jax was imported'\n"
        "bad = [m for m in sys.modules if m == 'cogview_tpu' or m.startswith('cogview_tpu.')]\n"
        "assert not bad, bad\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in ('PIL', 'ml_dtypes')]\n"
        "assert not bad, bad\n"
        "print('ok')\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0 and out.stdout.strip() == "ok", out.stderr

    with open(os.path.join(REPO, "chip_smoke.py")) as f:
        tree = ast.parse(f.read())
    names = [a.name for n in ast.walk(tree) if isinstance(n, ast.Import) for a in n.names]
    names += [f"{n.module}.{a.name}" for n in ast.walk(tree) if isinstance(n, ast.ImportFrom)
              for a in n.names]
    assert "cogview_tpu_torch.cli.serve" in names
    bad = [m for m in names if m == "cogview_tpu" or m.startswith(("cogview_tpu.", "jax"))]
    assert not bad, bad


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


def test_cli_image2text_and_post_selection_on_cpu(tmp_path, monkeypatch, capsys):
    """The CLI's image2text and post-selection tasks at the smoke preset on
    the CPU, with a narrow random VQ-VAE and a stand-in text tokenizer:
    20 text ids per row are printed, and the scores file holds the query
    and one finite negative score per candidate."""
    from cogview_tpu_torch.cli import generate
    from cogview_tpu_torch.utils.png import write_png

    class WordTok:
        num_tokens = 50000

        def encode(self, s):
            return [100 + i for i, _ in enumerate(s.split())]

        def decode(self, ids):
            return " ".join(map(str, ids))

    from cogview_tpu_torch.models import vqvae

    small = VQVAEConfig(channel=16, embed_dim=8)  # n_embed stays 8192
    monkeypatch.setattr(generate.TorchVQTokenizer, "random_init", classmethod(
        lambda cls, device=None: cls(vqvae.init_params(small, torch.Generator().manual_seed(0)),
                                     small, device)))
    rng = np.random.RandomState(0)
    imgs = []
    for i in range(2):
        imgs.append(str(tmp_path / f"{i}.png"))
        write_png(imgs[-1], rng.randint(0, 256, (256, 256, 3)).astype(np.uint8))
    common = ["--preset", "smoke", "--device", "cpu", "--output-path", str(tmp_path / "out")]

    q = tmp_path / "i2t.txt"
    q.write_text(imgs[0] + "\n")
    assert generate.main(["--generation-task", "image2text", "--batch-size", "2",
                          "--input-source", str(q)] + common, txt_tokenizer=WordTok()) == 0
    printed = [ast.literal_eval(line) for line in capsys.readouterr().out.splitlines()
               if line.startswith("[")]
    assert len(printed) == 2
    for parts in printed:  # the commands, then one string of the 20 text ids
        assert parts[:4] == ["[BASE]", "[BOI1]", "[EOI1]", "[ROI1]"]
        assert len(parts[-1].split()) == 20

    q = tmp_path / "ps.txt"
    q.write_text("\t".join(["w0 w1 w2"] + imgs) + "\n")
    assert generate.main(["--generation-task", "post-selection", "--input-source", str(q)]
                         + common, txt_tokenizer=WordTok()) == 0
    lines = (tmp_path / "out" / "scores_rank_0.txt").read_text().splitlines()
    assert lines[0] == q.read_text().strip()
    scores = [float(x) for x in lines[1].split("\t")]
    assert len(scores) == 2 and all(np.isfinite(x) and x < 0 for x in scores)
