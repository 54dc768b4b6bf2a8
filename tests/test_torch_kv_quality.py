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
