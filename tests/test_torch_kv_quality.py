"""The port's cache-quality script, ``cogview_tpu_torch/scripts/
kv_quality_check.py``, against the JAX package's ``scripts/kv_quality_check.py``
at the tiny preset on the CPU: the same weights (the JAX script's, through
``models/bridge.py``), the same seed for the prefix and the gumbel noise,
every reported key compared.

Both packages run the model in bfloat16 with different summation orders, so
their logits differ by bf16 roundings, and the quantities compared are
small differences of those logits (the int8 KL is about 1e-6 nats here).
Tolerance: each KL and the mean |delta logit| within a factor 1.5 of the
JAX script's, each flip rate within 4 steps of the B x T = 96.  The fault
this guards against, a port's cache 10x worse than the JAX package's, lies
far outside it."""

import contextlib
import importlib.util
import io
import json
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cogview_tpu.config import tiny_test as jax_tiny
from cogview_tpu.models import gpt as jgpt
from cogview_tpu_torch.models.bridge import gpt_params_from_jax
from cogview_tpu_torch.scripts import kv_quality_check as kq

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
B, T, SEED = 4, 24, 0
KEYS = ("kl_mean_nats", "kl_p99_nats", "argmax_flip_rate", "sampled_flip_rate",
        "mean_abs_dlogit_at_ref_argmax")


def _jax_script(monkeypatch, argv):
    """Run scripts/kv_quality_check.py's main with ``argv`` -> its JSON."""
    monkeypatch.setenv("COGVIEW_COMPILE_CACHE", "")
    monkeypatch.setattr(sys, "argv", ["kv_quality_check.py", *argv])
    spec = importlib.util.spec_from_file_location(
        "jax_kv_quality_check", os.path.join(REPO, "scripts", "kv_quality_check.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        mod.main()
    return json.loads(out.getvalue().strip().splitlines()[-1])


def test_kv_quality_matches_the_jax_script(monkeypatch):
    want = _jax_script(monkeypatch, ["--preset", "tiny", "--batch", str(B), "--steps", str(T),
                                     "--seed", str(SEED), "--json"])
    # the JAX script's own weights: PRNGKey(seed), bfloat16
    jparams = jgpt.init_params(jax.random.PRNGKey(SEED), jax_tiny(compute_dtype=jnp.bfloat16),
                               dtype=jnp.bfloat16)
    params = gpt_params_from_jax(jax.tree.map(np.asarray, jparams))
    got = kq.run(torch.device("cpu"), "tiny", B, T, 33, SEED, params=params, verbose=False)
    for k in ("preset", "batch", "steps", "prefix", "seed"):
        assert got[k] == want[k]
    for kv in kq.CACHES:
        g, w = got[kv], want[kv]
        assert set(g) == set(KEYS) == set(w)
        for k in ("kl_mean_nats", "kl_p99_nats", "mean_abs_dlogit_at_ref_argmax"):
            assert w[k] > 0 and w[k] / 1.5 <= g[k] <= w[k] * 1.5, (kv, k, g[k], w[k])
        for k in ("argmax_flip_rate", "sampled_flip_rate"):
            assert abs(g[k] - w[k]) <= 4 / (B * T), (kv, k, g[k], w[k])
    # the int4 cache is the coarser one in both
    assert got["int4"]["kl_mean_nats"] > got["int8"]["kl_mean_nats"]


def test_kv_quality_needs_a_card_unless_told_cpu(monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit, match="--device cpu"):
        kq.main(["--preset", "tiny", "--batch", "1", "--steps", "2"])
    out = kq.main(["--preset", "tiny", "--batch", "1", "--steps", "2", "--json",
                   "--device", "cpu"])
    printed = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert printed == out and set(out["int8"]) == set(KEYS) == set(out["int4"])
    with pytest.raises(SystemExit, match="positions"):
        kq.main(["--preset", "tiny", "--steps", "40", "--device", "cpu"])


TUTORIAL_STEPS = 128  # of the JAX record's 256: the CPU takes minutes a cache


@pytest.mark.slow
def test_kv_quality_matches_the_jax_script_at_tutorial(monkeypatch):
    """The flip rates on the same weights (ROADMAP C4): both scripts at the
    tutorial preset (12 layers, hidden 1024, the 58,240-token vocabulary),
    batch 4, TUTORIAL_STEPS steps, the JAX script's PRNGKey(0) weights
    through models/bridge.py.  The rule is the tiny test's.  Prints both
    results as JSON lines (run with -s to see them)."""
    from cogview_tpu.config import cogview_tutorial

    want = _jax_script(monkeypatch, ["--preset", "tutorial", "--batch", str(B), "--steps",
                                     str(TUTORIAL_STEPS), "--seed", str(SEED), "--json"])
    jparams = jgpt.init_params(jax.random.PRNGKey(SEED), cogview_tutorial(),
                               dtype=jnp.bfloat16)
    params = gpt_params_from_jax(jax.tree.map(np.asarray, jparams))
    del jparams
    got = kq.run(torch.device("cpu"), "tutorial", B, TUTORIAL_STEPS, 33, SEED, params=params,
                 verbose=False)
    print(json.dumps({"jax": want}))
    print(json.dumps({"port": got}))
    for kv in kq.CACHES:
        g, w = got[kv], want[kv]
        for k in ("kl_mean_nats", "kl_p99_nats", "mean_abs_dlogit_at_ref_argmax"):
            assert w[k] > 0 and w[k] / 1.5 <= g[k] <= w[k] * 1.5, (kv, k, g[k], w[k])
        for k in ("argmax_flip_rate", "sampled_flip_rate"):
            assert abs(g[k] - w[k]) <= 4 / (B * TUTORIAL_STEPS), (kv, k, g[k], w[k])


def _jax_rollout(params, cfg, prefix, steps, vocab, forced=None):
    """The JAX script's rollout (scripts/kv_quality_check.py): prefill, then
    ``steps`` decode steps, greedy over the image vocabulary unless
    ``forced`` -> (logits [B, steps, V] float32, tokens [B, steps])."""
    B, S0 = prefix.shape
    total = S0 + steps
    pos = np.broadcast_to(np.arange(total, dtype=np.int32), (B, total))
    cache = jgpt.init_cache(cfg, B, total)
    prefill = jax.jit(lambda p, t, q, c: jgpt.forward_with_cache(p, cfg, t, q, c, 0))
    step = jax.jit(lambda p, t, q, c, i: jgpt.forward_with_cache(p, cfg, t, q, c, i))
    lg, cache = prefill(params, jnp.asarray(prefix), jnp.asarray(pos[:, :S0]), cache)
    cur = np.asarray(lg[:, -1]).astype(np.float32)
    logits, toks = [], []
    for t in range(steps):
        logits.append(cur)
        nxt = cur[:, :vocab].argmax(-1).astype(np.int32) if forced is None else forced[:, t]
        toks.append(nxt)
        lg, cache = step(params, jnp.asarray(nxt[:, None]),
                         jnp.asarray(pos[:, S0 + t:S0 + t + 1]), cache, jnp.int32(S0 + t))
        cur = np.asarray(lg[:, 0]).astype(np.float32)
    return np.stack(logits, 1), np.stack(toks, 1)


@pytest.mark.slow
def test_kv_quality_flips_along_one_stream_at_tutorial():
    """C4's follow-up: each script forces its caches along the stream its
    own bf16 cache generates, so the two flip counts may be of different
    steps.  Here both packages force their bf16 and int4 caches along the
    JAX package's bf16 stream (tutorial, batch 4, TUTORIAL_STEPS steps, the
    same weights and prefix), the flips are counted by one function
    (``kq.compare``) and held to the rule above.  Prints the steps where the
    two packages' own bf16 streams first differ, and both results."""
    from cogview_tpu.config import cogview_tutorial

    cfg_j = cogview_tutorial()
    vocab, T = kq.img_vocab("tutorial"), TUTORIAL_STEPS
    jparams = jgpt.init_params(jax.random.PRNGKey(SEED), cfg_j, dtype=jnp.bfloat16)
    params = gpt_params_from_jax(jax.tree.map(np.asarray, jparams))
    prefix = np.random.RandomState(SEED).randint(
        vocab, min(cfg_j.vocab_size, vocab + 1000), (B, 33)).astype(np.int32)
    gumbel = np.random.RandomState(SEED + 1).gumbel(size=(B, T, vocab)).astype(np.float32)

    j_ref, stream = _jax_rollout(jparams, cfg_j.replace(kv_cache_dtype="bfloat16"), prefix,
                                 T, vocab)
    j_int4, _ = _jax_rollout(jparams, cfg_j.replace(kv_cache_dtype="int4"), prefix, T, vocab,
                             stream)
    del jparams
    cfg = kq.PRESETS["tutorial"]()
    ids = torch.as_tensor(prefix, dtype=torch.long)
    with torch.no_grad():
        _, own = kq.rollout(params, cfg.replace(kv_cache_dtype="bfloat16"), ids, T, vocab)
        t_ref, _ = kq.rollout(params, cfg.replace(kv_cache_dtype="bfloat16"), ids, T, vocab,
                              stream)
        t_int4, _ = kq.rollout(params, cfg.replace(kv_cache_dtype="int4"), ids, T, vocab,
                               stream)
    differ = own != stream
    first = [int(np.argmax(r)) if r.any() else None for r in differ]
    want, got = kq.compare(j_ref, j_int4, gumbel, vocab), kq.compare(t_ref, t_int4, gumbel,
                                                                    vocab)
    print(json.dumps({"own_streams_differ_steps": int(differ.sum()),
                      "first_difference_per_row": first, "jax_int4": want, "port_int4": got}))
    for k in ("argmax_flip_rate", "sampled_flip_rate"):
        assert abs(got[k] - want[k]) <= 4 / (B * T), (k, got[k], want[k])


@pytest.mark.slow
@pytest.mark.parametrize("threads", [1, 2])
def test_bf16_streams_part_at_near_ties_at_tutorial(threads):
    """C4's measurement: where the two packages' bf16 streams part, is it a
    near-tie or a rounding the port does differently?  Both packages run the
    bf16 cache along the JAX package's greedy stream (tutorial, batch 4, the
    JAX script's PRNGKey(0) weights, the same prefix), so at every step they
    see the same prefix.  At each step where the port's argmax differs from
    the JAX stream's token: the two candidates' logit margin in each
    package's logits, against the largest |delta logit| between the
    packages at that step (over the image vocabulary).  A near-tie is a
    margin below that delta: the packages' own bf16 roundings, not a
    misrounded op, decide it.  The port runs on 1 and on 2 CPU threads,
    which sum its float32 matmuls in other orders.  Prints one JSON line per
    parting step."""
    from cogview_tpu.config import cogview_tutorial

    cfg_j = cogview_tutorial()
    vocab, T = kq.img_vocab("tutorial"), 100  # the recorded partings are at steps 62, 99
    jparams = jgpt.init_params(jax.random.PRNGKey(SEED), cfg_j, dtype=jnp.bfloat16)
    params = gpt_params_from_jax(jax.tree.map(np.asarray, jparams))
    prefix = np.random.RandomState(SEED).randint(
        vocab, min(cfg_j.vocab_size, vocab + 1000), (B, 33)).astype(np.int32)
    j_ref, stream = _jax_rollout(jparams, cfg_j.replace(kv_cache_dtype="bfloat16"), prefix,
                                 T, vocab)
    del jparams
    cfg = kq.PRESETS["tutorial"]()
    before = torch.get_num_threads()
    torch.set_num_threads(threads)
    try:
        with torch.no_grad():
            t_ref, _ = kq.rollout(params, cfg.replace(kv_cache_dtype="bfloat16"),
                                  torch.as_tensor(prefix, dtype=torch.long), T, vocab, stream)
    finally:
        torch.set_num_threads(before)
    jl, tl = j_ref[..., :vocab], t_ref[..., :vocab]
    port_pick = tl.argmax(-1)
    parts = []
    for b, t in zip(*np.nonzero(port_pick != stream)):
        a, c = stream[b, t], port_pick[b, t]
        parts.append(dict(threads=threads, row=int(b), step=int(t), jax_token=int(a),
                          port_token=int(c),
                          jax_margin=float(jl[b, t, a] - jl[b, t, c]),
                          port_margin=float(tl[b, t, c] - tl[b, t, a]),
                          max_abs_dlogit=float(np.abs(jl[b, t] - tl[b, t]).max()),
                          mean_abs_dlogit=float(np.abs(jl[b, t] - tl[b, t]).mean())))
        print(json.dumps(parts[-1]))
    assert parts, "the streams did not part in these steps"
    for p in parts:
        assert max(p["jax_margin"], p["port_margin"]) < p["max_abs_dlogit"], p
