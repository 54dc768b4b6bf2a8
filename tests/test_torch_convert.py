"""The port's checkpoint import against the JAX package's
(``cogview_tpu_torch/models/convert.py`` against ``cogview_tpu/models/
convert.py``, mirroring tests/test_convert_streaming.py), the GPT-2 warm
start, and the CLIs' ``--load``, ``--img-tokenizer-path`` and ``--with-id``.

The released checkpoints are not in the repo, so every file here is a
synthetic state dict in the reference's key layout.  Tolerance: every
converted leaf bit-equal to the JAX converter's, compared through its bit
pattern (bfloat16 and float16 as 16-bit words), in the stored dtype; logits
through the two CLIs' ``load_model`` within test_torch_gpt.py's 1e-4."""

import argparse

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from cogview_tpu.cli import generate as jcli
from cogview_tpu.config import tiny_test as jax_tiny
from cogview_tpu.models import convert as jconvert
from cogview_tpu.models import gpt as jgpt
from cogview_tpu.models import hf_import as jhf
from cogview_tpu_torch.cli import generate, pretrain, serve
from cogview_tpu_torch.config import smoke, tiny_test
from cogview_tpu_torch.models import convert, gpt, hf_import
from cogview_tpu_torch.models.bridge import gpt_params_from_jax, vqvae_params_from_jax
from cogview_tpu_torch.training import checkpointing
from cogview_tpu_torch.utils.png import write_png

torch.set_num_threads(1)

L, H, V, P = 48, 32, 96, 40  # a 48-layer layout at a tiny width


def _gpt_sd(L=L, H=H, V=V, P=P, dtype=torch.float16, prefix="", seed=0):
    g = torch.Generator().manual_seed(seed)
    sd = {}

    def t(*shape):
        return (torch.randn(*shape, generator=g) * 0.3).to(dtype)

    sd[prefix + "word_embeddings.weight"] = t(V, H)
    sd[prefix + "transformer.position_embeddings.weight"] = t(P, H)
    for i in range(L):
        b = f"{prefix}transformer.layers.{i}."
        for name, shape in (("input_layernorm", (H,)), ("post_attention_layernorm", (H,)),
                            ("third_layernorm", (H,)), ("fourth_layernorm", (H,))):
            sd[b + name + ".weight"] = 1 + t(*shape)
            sd[b + name + ".bias"] = t(*shape)
        sd[b + "attention.query_key_value.weight"] = t(3 * H, H)
        sd[b + "attention.query_key_value.bias"] = t(3 * H)
        sd[b + "attention.dense.weight"] = t(H, H)
        sd[b + "attention.dense.bias"] = t(H)
        sd[b + "mlp.dense_h_to_4h.weight"] = t(4 * H, H)
        sd[b + "mlp.dense_h_to_4h.bias"] = t(4 * H)
        sd[b + "mlp.dense_4h_to_h.weight"] = t(H, 4 * H)
        sd[b + "mlp.dense_4h_to_h.bias"] = t(H)
    sd[prefix + "transformer.final_layernorm.weight"] = 1 + t(H)
    sd[prefix + "transformer.final_layernorm.bias"] = t(H)
    return sd


def _bits(a) -> np.ndarray:
    """A leaf's bit pattern: a torch tensor or a numpy array (ml_dtypes
    bfloat16 included) -> unsigned integers of its width."""
    if isinstance(a, torch.Tensor):
        a = a.detach().cpu()
        if a.dtype == torch.bfloat16:
            return a.view(torch.int16).numpy().view(np.uint16)
        a = a.numpy()
    a = np.ascontiguousarray(np.asarray(a))
    return a.view({1: np.uint8, 2: np.uint16, 4: np.uint32, 8: np.uint64}[a.dtype.itemsize])


def _dtype_name(a) -> str:
    return str(a.dtype).replace("torch.", "")


def _assert_trees_bit_equal(got, want, path=""):
    if isinstance(want, dict):
        assert set(got) == set(want), (path, set(got) ^ set(want))
        for k in want:
            _assert_trees_bit_equal(got[k], want[k], f"{path}.{k}")
        return
    assert tuple(got.shape) == tuple(np.shape(want)), path
    assert _dtype_name(got) == _dtype_name(np.asarray(want)), (path, got.dtype, want.dtype)
    np.testing.assert_array_equal(_bits(got), _bits(want), err_msg=path)


# --------------------------------------------------------------------- #
# converters
# --------------------------------------------------------------------- #


@pytest.mark.parametrize("dtype", [torch.float16, torch.bfloat16, torch.float32])
@pytest.mark.parametrize("prefix", ["", "module."])
def test_gpt_converter_bit_equal_to_jax_in_the_stored_dtype(dtype, prefix):
    want = jconvert.gpt_from_state_dict(_gpt_sd(dtype=dtype, prefix=prefix), L, 4, consume=True)
    sd = _gpt_sd(dtype=dtype, prefix=prefix)
    got = convert.gpt_from_state_dict(sd, L, 4, consume=True)
    assert len(sd) == 0, f"{len(sd)} tensors left in the source dict"
    _assert_trees_bit_equal(got, want)
    assert all(t.dtype == dtype for t in jax.tree.leaves(got))
    assert got["layers"]["qkv"]["w"].shape == (L, H, 3, H)
    assert got["layers"]["mlp_in"]["w"].shape == (L, H, 4 * H)


def test_gpt_converter_without_consume_keeps_the_source_and_takes_a_dtype():
    sd = _gpt_sd(prefix="module.")
    n = len(sd)
    got = convert.gpt_from_state_dict(sd, L, 4, dtype=torch.float32)
    want = jconvert.gpt_from_state_dict(_gpt_sd(prefix="module."), L, 4, dtype=np.float32)
    assert len(sd) == n
    _assert_trees_bit_equal(got, want)


VQ_SHAPES = {  # the reference VQ-VAE at channel 16, embed 8, 32 codes
    "enc_b.blocks.0": (16, 3, 4, 4), "enc_b.blocks.2": (16, 16, 4, 4),
    "enc_b.blocks.4": (16, 16, 4, 4), "enc_b.blocks.6": (8, 16, 1, 1),
    "dec.blocks.0": (8, 16, 4, 4), "dec.blocks.2": (16, 16, 4, 4),
    "dec.blocks.4": (16, 16, 4, 4), "dec.blocks.6": (3, 16, 1, 1),
}


def _vq_sd(prefix="", seed=1):
    g = torch.Generator().manual_seed(seed)
    sd = {}
    for name, shape in VQ_SHAPES.items():
        sd[f"{prefix}{name}.weight"] = torch.randn(*shape, generator=g) * 0.2
        sd[f"{prefix}{name}.bias"] = torch.randn(shape[1] if name.startswith("dec.blocks.")
                                                 and name != "dec.blocks.6" else shape[0],
                                                 generator=g) * 0.1
    sd[prefix + "quantize_t.embed"] = torch.randn(8, 32, generator=g)
    sd[prefix + "quantize_t.cluster_size"] = torch.rand(32, generator=g)
    sd[prefix + "quantize_t.embed_avg"] = torch.randn(8, 32, generator=g)
    return sd


@pytest.mark.parametrize("prefix", ["", "module."])
def test_vqvae_converter_bit_equal_to_jax(prefix):
    """The port keeps PyTorch's conv layouts, so its converter only renames;
    the JAX converter's HWIO leaves, bridged back, equal it bit for bit.
    The codebook's EMA statistics are dropped."""
    want = vqvae_params_from_jax(jconvert.vqvae_from_state_dict(_vq_sd(prefix)))
    got = convert.vqvae_from_state_dict(_vq_sd(prefix))
    assert set(got["quantize"]) == {"embed"}
    _assert_trees_bit_equal(got, want)


@pytest.mark.parametrize("wrap", ["bare", "state_dict"])
def test_vqvae_checkpoint_file_and_tokenizer_match_jax(tmp_path, wrap):
    from cogview_tpu.models import vqvae as jvq
    from cogview_tpu.tokenization.vq_tokenizer import JaxVQTokenizer
    from cogview_tpu_torch.config import VQVAEConfig
    from cogview_tpu_torch.tokenization.vq_tokenizer import TorchVQTokenizer

    sd = _vq_sd("module.")
    path = str(tmp_path / "vqvae.pt")
    torch.save(sd if wrap == "bare" else {"state_dict": sd}, path)
    jtok = JaxVQTokenizer.from_checkpoint(path, jvq.VQVAEConfig(channel=16, embed_dim=8,
                                                                n_embed=32))
    ttok = TorchVQTokenizer.from_checkpoint(path, VQVAEConfig(channel=16, embed_dim=8,
                                                              n_embed=32))
    assert ttok.num_tokens == 32
    img = np.random.RandomState(2).randn(2, 32, 32, 3).astype(np.float32)
    codes = ttok.EncodeAsIds(img)
    np.testing.assert_array_equal(codes, jtok.EncodeAsIds(img))
    np.testing.assert_allclose(ttok.DecodeIds(codes), jtok.DecodeIds(codes), atol=1e-4)


# --------------------------------------------------------------------- #
# file layouts
# --------------------------------------------------------------------- #


@pytest.mark.parametrize("layout", ["deepspeed", "model", "bare-prefixed", "legacy"])
def test_load_gpt_checkpoint_file_layouts(tmp_path, layout):
    """DeepSpeed's {"module": sd} with a non-tensor entry (read through
    mmap), {"model": sd}, a module.-prefixed bare state dict, and a legacy
    non-zip file (no mmap path)."""
    sd = _gpt_sd(prefix="module." if layout == "bare-prefixed" else "")
    obj = {"deepspeed": {"module": sd, "args": argparse.Namespace(num_layers=L)},
           "model": {"model": sd, "iteration": 7}, "bare-prefixed": sd, "legacy": sd}[layout]
    path = str(tmp_path / "mp_rank_00_model_states.pt")
    torch.save(obj, path, _use_new_zipfile_serialization=layout != "legacy")
    got = convert.load_gpt_checkpoint(path, L, 4)
    want = jconvert.load_gpt_checkpoint(path, L, 4)
    _assert_trees_bit_equal(got, want)
    assert got["embed"]["word"].dtype == torch.float16


# --------------------------------------------------------------------- #
# through the CLIs
# --------------------------------------------------------------------- #


def _cli_args(parser, preset, path, dtype="float32"):
    return parser.parse_args(["--preset", preset, "--load", path, "--dtype", dtype,
                              "--kv-cache", "int8"])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cli_load_model_matches_jax(tmp_path, dtype):
    """One DeepSpeed file (float16) through both CLIs' load_model at the tiny
    preset: float16 leaves stay float16 in both (only float32 leaves take the
    compute dtype), every leaf bit-equal, and float32 logits within 1e-4."""
    sd = _gpt_sd(L=2, H=64, V=128, P=64, seed=3)
    path = str(tmp_path / "mp_rank_00_model_states.pt")
    torch.save({"module": sd}, path)
    jparams, jcfg = jcli.load_model(_cli_args(jcli.build_parser(), "tiny", path, dtype))
    params, cfg = generate.load_model(_cli_args(generate.build_parser(), "tiny", path, dtype),
                                      torch.device("cpu"))
    _assert_trees_bit_equal(params, jax.tree.map(np.asarray, jparams))
    assert params["layers"]["ln_in"]["g"].dtype == torch.float16
    tokens = np.random.RandomState(0).randint(0, 128, (2, 24)).astype(np.int32)
    want = np.asarray(jgpt.forward(jparams, jcfg.replace(compute_dtype=jnp.float32),
                                   jnp.asarray(tokens)))
    got = gpt.forward(params, cfg.replace(compute_dtype=torch.float32),
                      torch.from_numpy(tokens).long())
    np.testing.assert_allclose(got.numpy(), want, atol=1e-4)


@pytest.mark.parametrize("positions", [150, 40])
def test_position_table_fitted_after_load_as_jax(tmp_path, monkeypatch, positions):
    """A 64-position file under a preset of another length: tiled (or
    truncated) as JAX's adapt_position_embeddings does."""
    sd = _gpt_sd(L=2, H=64, V=128, P=64, seed=4)
    path = str(tmp_path / "ckpt.pt")
    torch.save({"module": sd}, path)
    monkeypatch.setitem(jcli.PRESETS, "tiny-pos", lambda: jax_tiny(
        max_position_embeddings=positions))
    monkeypatch.setitem(generate.PRESETS, "tiny-pos", lambda: tiny_test(
        max_position_embeddings=positions))
    jparams, _ = jcli.load_model(_cli_args(jcli.build_parser(), "tiny-pos", path))
    params, _ = generate.load_model(_cli_args(generate.build_parser(), "tiny-pos", path),
                                    torch.device("cpu"))
    pos = params["embed"]["pos"]
    assert pos.shape == (positions, 64) and pos.dtype == torch.float16
    np.testing.assert_array_equal(_bits(pos), _bits(np.asarray(jparams["embed"]["pos"])))
    src = sd["transformer.position_embeddings.weight"]
    assert torch.equal(pos[:min(64, positions)], src[:positions])
    assert torch.equal(pos, gpt.extend_position_embedding(src, positions))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("hf_layers", [3, 1])
def test_load_hf_gpt2_into_matches_jax(dtype, hf_layers):
    jdt = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}[dtype]
    jparams = jgpt.init_params(jax.random.PRNGKey(0), jax_tiny(), dtype=jdt)
    g = torch.Generator().manual_seed(5)
    Ht = 64
    sd = {"wte.weight": torch.randn(50, Ht, generator=g),
          "wpe.weight": torch.randn(80, Ht, generator=g),
          "ln_f.weight": torch.randn(Ht, generator=g), "ln_f.bias": torch.randn(Ht, generator=g)}
    for i in range(hf_layers):
        for name, shape in (("attn.c_attn.weight", (Ht, 3 * Ht)), ("attn.c_attn.bias", (3 * Ht,)),
                            ("attn.c_proj.weight", (Ht, Ht)), ("attn.c_proj.bias", (Ht,)),
                            ("mlp.c_fc.weight", (Ht, 4 * Ht)), ("mlp.c_fc.bias", (4 * Ht,)),
                            ("mlp.c_proj.weight", (4 * Ht, Ht)), ("mlp.c_proj.bias", (Ht,)),
                            ("ln_1.weight", (Ht,)), ("ln_1.bias", (Ht,)),
                            ("ln_2.weight", (Ht,)), ("ln_2.bias", (Ht,))):
            sd[f"h.{i}.{name}"] = torch.randn(*shape, generator=g)
    np_params = jax.tree.map(np.asarray, jparams)
    want = jhf.load_hf_gpt2_into(np_params, {k: v.numpy() for k, v in sd.items()},
                                 txt_offset=32)
    before = gpt_params_from_jax(np_params)
    got = hf_import.load_hf_gpt2_into(before, sd, txt_offset=32)
    _assert_trees_bit_equal(got, want)
    # the input params are left as they were
    _assert_trees_bit_equal(before, np_params)
    assert not torch.equal(got["layers"]["qkv"]["w"][0], before["layers"]["qkv"]["w"][0])


def test_both_clis_list_tutorial():
    for parser in (generate.build_parser(), serve.build_parser()):
        preset = next(a for a in parser._actions if a.dest == "preset")
        assert "tutorial" in preset.choices
    assert generate.PRESETS["tutorial"]().num_layers == 12


class WordTok:
    num_tokens = 50000

    def encode(self, text):
        return [100 + sum(map(ord, w)) % 3000 for w in text.split()]

    def decode(self, ids):
        return " ".join(f"<{i}>" for i in ids)


def _smoke_files(tmp_path):
    """A smoke-width DeepSpeed file, a narrow VQ-VAE file and two PNGs."""
    cfg = smoke()
    gpt_path = str(tmp_path / "mp_rank_00_model_states.pt")
    torch.save({"module": _gpt_sd(L=cfg.num_layers, H=cfg.hidden_size, V=cfg.vocab_size,
                                  P=cfg.max_position_embeddings, seed=6)}, gpt_path)
    vq_path = str(tmp_path / "vqvae.pt")
    torch.save(_vq_sd(), vq_path)
    rng = np.random.RandomState(7)
    pngs = []
    for i in range(2):
        pngs.append(str(tmp_path / f"{i}.png"))
        write_png(pngs[-1], rng.randint(0, 256, (256, 256, 3)).astype(np.uint8))
    return gpt_path, vq_path, pngs


def test_generate_with_id_load_and_img_tokenizer_path(tmp_path, capsys):
    """Post-selection through ``cli.generate.main`` on the CPU at the smoke
    preset with --load, --img-tokenizer-path and --with-id: each line's
    scores land in <output-path>/<id>/, and no random-weight warning is
    printed."""
    gpt_path, vq_path, pngs = _smoke_files(tmp_path)
    query = tmp_path / "q.txt"
    query.write_text(f"first\tw0 w1\t{pngs[0]}\t{pngs[1]}\nsecond\tw2\t{pngs[1]}\n")
    out = tmp_path / "out"
    rc = generate.main(["--preset", "smoke", "--device", "cpu", "--load", gpt_path,
                        "--img-tokenizer-path", vq_path, "--with-id",
                        "--generation-task", "post-selection", "--input-source", str(query),
                        "--output-path", str(out)], txt_tokenizer=WordTok())
    assert rc == 0
    assert "[warn]" not in capsys.readouterr().err
    assert sorted(p.name for p in out.iterdir()) == ["first", "second"]
    for qid, n in (("first", 2), ("second", 1)):
        lines = (out / qid / "scores_rank_0.txt").read_text().splitlines()
        scores = [float(x) for x in lines[1].split("\t")]
        assert len(scores) == n and all(np.isfinite(scores)) and all(s < 0 for s in scores)


def test_serve_takes_load_and_img_tokenizer_path(tmp_path, capsys):
    """One image->text query file through ``cli.serve.main`` with --load and
    --img-tokenizer-path at the smoke preset on the CPU."""
    gpt_path, vq_path, pngs = _smoke_files(tmp_path)
    inp, img = tmp_path / "in", tmp_path / "img"
    inp.mkdir()
    (inp / "q.txt").write_text(pngs[0] + "\n")
    rc = serve.main(["--preset", "smoke", "--device", "cpu", "--load", gpt_path,
                     "--img-tokenizer-path", vq_path, "--generation-task", "image2text",
                     "--batch-size", "1", "--input-folder-path", str(inp),
                     "--img-folder-path", str(img), "--max-polls", "1", "--time-interval", "0",
                     "--no-warmup"], txt_tokenizer=WordTok())
    assert rc == 0
    assert "[warn]" not in capsys.readouterr().err
    assert (inp / "done" / "q.txt").exists() and not list((inp / "failed").iterdir())
    assert len((img / "q-0" / "captions.txt").read_text().splitlines()) == 1


def test_pretrain_checkpoint_loads_through_load(tmp_path):
    """A checkpoint the port's pretrain CLI writes (smoke preset: the tiny
    preset's 64 positions cannot hold a training row) loads through --load:
    float32 params become bfloat16 under the dtype rule, equal to the saved
    ones cast; with --dtype float32 they are the saved ones."""
    rng = np.random.RandomState(0)
    data = np.full((8, 64 + 1024), -1, np.int32)
    data[:, :12] = rng.randint(8192, 58192, size=(8, 12))
    data[:, 64:] = rng.randint(0, 8192, size=(8, 1024))
    corpus = tmp_path / "t2i.bin"
    data.tofile(corpus)
    save = tmp_path / "ckpt"
    rc = pretrain.main(["--preset", "smoke", "--device", "cpu", "--train-data", str(corpus),
                        "--batch-size", "2", "--split", "1,0,0", "--train-iters", "1",
                        "--save", str(save), "--save-interval", "1", "--log-interval", "1"],
                       txt_tokenizer=argparse.Namespace(num_tokens=50000))
    assert rc == 0
    saved = checkpointing.load_latest(str(save))["params"]
    for dtype, torch_dtype in (("bfloat16", torch.bfloat16), ("float32", torch.float32)):
        params, cfg = generate.load_model(
            generate.build_parser().parse_args(["--preset", "smoke", "--load", str(save),
                                                "--dtype", dtype]), torch.device("cpu"))
        want = jax.tree.map(lambda t: t.to(torch_dtype), saved)
        assert jax.tree.structure(params) == jax.tree.structure(want)
        for (kp, got), (_, w) in zip(jax.tree_util.tree_leaves_with_path(params),
                                     jax.tree_util.tree_leaves_with_path(want)):
            assert got.dtype == torch_dtype and torch.equal(got, w), kp
