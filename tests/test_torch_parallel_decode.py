"""The port's sharded decode (cogview_tpu_torch/parallel) on 4 gloo CPU
processes, (dp, mp) = (2, 2): the int8, int4 and bfloat16 caches with
rows over 'data' and heads over 'model' against the JAX package's *unsharded* ``forward_with_cache`` logits, a
sharded ``filling_sequence`` against the JAX sampler's ids, and the
multi-rank dry run.  tiny_test widths in float32; groups on a FileStore
under tmp_path, every spawn with its own time limit.

Tolerance: logits to 1e-4 absolute.  The sharded projections sum the same
products as the unsharded ones in another order, and the int8/int4
rounding of K and V can move a value near a rounding boundary by one
level; 1e-4 is the single-device decode tests' tolerance."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from cogview_tpu.config import tiny_test as jax_tiny
from cogview_tpu.generation import sampling as js
from cogview_tpu.models import gpt as jgpt
from cogview_tpu.ops.hash_prng import seed_from_key
from cogview_tpu.tokenization.unified import FakeImageTokenizer, UnifiedTokenizer
from cogview_tpu.utils.rng import rbg_key
from cogview_tpu_torch import dryrun
from cogview_tpu_torch.generation import sampling as ts
from cogview_tpu_torch.models.bridge import gpt_params_from_jax
from cogview_tpu_torch.parallel.spawn import run_ranks

import torch_parallel_workers as workers

torch.set_num_threads(1)

TIMEOUT = 240


@pytest.mark.parametrize("kv,int8_weights",
                         [("int8", True), ("int4", False), ("bfloat16", False)])
def test_sharded_decode_matches_unsharded_jax(kv, int8_weights, tmp_path):
    """Batch 4 over data=2, 8 heads over model=2 (4 a rank): a 10-token
    prefill and 14 decode steps (two seals), every step's logits."""
    jcfg = jax_tiny(kv_cache_dtype=kv)
    jparams = jgpt.init_params(jax.random.PRNGKey(3), jcfg)
    params0 = gpt_params_from_jax(jax.tree.map(np.asarray, jparams))
    if int8_weights:
        jparams = jgpt.quantize_weights(jparams)
    B, S, ctx = 4, 24, 10
    toks = np.random.RandomState(4).randint(0, 128, (B, S)).astype(np.int32)
    pos = np.broadcast_to(np.arange(S, dtype=np.int32), (B, S))
    cache = jgpt.init_cache(jcfg, B, S)
    lg, cache = jgpt.forward_with_cache(jparams, jcfg, jnp.asarray(toks[:, :ctx]),
                                        jnp.asarray(pos[:, :ctx]), cache, 0)
    want = [np.asarray(lg)]
    # the decode step jitted with a traced index, as the JAX sampler runs it
    step = jax.jit(lambda p, t, po, c, i: jgpt.forward_with_cache(p, jcfg, t, po, c, i))
    for t in range(ctx, S):
        lg, cache = step(jparams, jnp.asarray(toks[:, t:t + 1]), jnp.asarray(pos[:, t:t + 1]),
                         cache, jnp.int32(t))
        want.append(np.asarray(lg))
    torch.save({"mesh": (2, 2), "cfg": dict(kv_cache_dtype=kv), "params": params0,
                "int8_weights": int8_weights, "tokens": torch.from_numpy(toks).long(),
                "positions": torch.from_numpy(pos.copy()).long(), "ctx": ctx},
               tmp_path / "in.pt")
    run_ranks(workers.decode_steps, 4, str(tmp_path), str(tmp_path), timeout=TIMEOUT)
    got = torch.load(tmp_path / "out.pt", weights_only=False)
    assert len(got) == len(want)
    for i, (g, w) in enumerate(zip(got, want)):
        assert g.shape == w.shape
        np.testing.assert_allclose(g.numpy(), w, atol=1e-4, rtol=0, err_msg=f"step {i}")


class TinyTextTok:
    num_tokens = 64

    def encode(self, s):
        return [ord(c) % 64 for c in s]

    def decode(self, ids):
        return "".join(chr(97 + (i % 26)) for i in ids)


def test_sharded_filling_sequence_matches_jax_ids(tmp_path):
    """text->image template filling at batch 4 on the (2, 2) mesh with the
    int8 cache: the same ids as the JAX sampler's unsharded loop, scores
    to 1e-4 (the gumbel draws hash the rows' global ids)."""
    tok = UnifiedTokenizer(img_tokenizer=FakeImageTokenizer(32), txt_tokenizer=TinyTextTok())
    seq = ([tok["[ROI1]"], 40, 50, tok["[BASE]"], tok["[BOI1]"]] + [-1] * 8
           + [tok["[EOI1]"]] + [-1] * 3)
    jcfg = jax_tiny(kv_cache_dtype="int8")
    jparams = jgpt.init_params(jax.random.PRNGKey(0), jcfg)
    sp = js.SamplingParams(top_k=10, top_p=0.9, seed=11)
    want_t, want_s = js.filling_sequence(jparams, jcfg, js.compile_template(seq, tok, 128), 4,
                                         sp)
    torch.save({"mesh": (2, 2), "cfg": dict(kv_cache_dtype="int8"),
                "params": gpt_params_from_jax(jax.tree.map(np.asarray, jparams)),
                "template": ts.compile_template(seq, tok, padded_vocab=128), "batch": 4,
                "sampling": ts.SamplingParams(top_k=10, top_p=0.9, seed=11),
                "seed": int(seed_from_key(rbg_key(11)))}, tmp_path / "in.pt")
    run_ranks(workers.fill, 4, str(tmp_path), str(tmp_path), timeout=TIMEOUT)
    got = torch.load(tmp_path / "out.pt", weights_only=False)
    np.testing.assert_array_equal(got["tokens"].numpy(), np.asarray(want_t))
    np.testing.assert_allclose(got["scores"].numpy(), np.asarray(want_s), atol=1e-4)
    assert len({tuple(r) for r in np.asarray(want_t).tolist()}) > 1  # rows differ


def test_dryrun_multichip_four_ranks():
    lines = dryrun.dryrun_multichip(4, device="cpu", timeout=TIMEOUT)
    assert len(lines) == 6 and all(ln.startswith("dryrun_multichip ok") for ln in lines), lines
