"""Port parity: the plain versions of the probe kernels (P1a, P1b, P2)
against the Pallas kernels of the JAX package's probe scripts, run in
interpret mode on the CPU, and the port's three measurement entry points
under ``--device cpu`` at small shapes.

The scripts define their kernels inside ``main``, so the oracle parses each
script with ``ast`` and executes the nested definitions it needs in a
namespace that binds the script's constants and a ``pl`` whose
``pallas_call`` runs in interpret mode.  Nothing under ``scripts/`` changes.
Every comparison is exact: the probes add, copy and select integers."""

import ast
import functools
import math
import os
import types

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax import lax
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

from cogview_tpu_torch.config import tiny_test
from cogview_tpu_torch.ops import probes
from cogview_tpu_torch.scripts import decode_kernel_microbench as dkm
from cogview_tpu_torch.scripts import launch_probe as lp
from cogview_tpu_torch.scripts import seal_scatter_probe as ssp

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _interpret_pl():
    """``pl`` with every ``pallas_call`` in interpret mode."""
    mod = types.SimpleNamespace(**{k: getattr(pl, k) for k in dir(pl) if not k.startswith("_")})
    mod.pallas_call = functools.partial(pl.pallas_call, interpret=True)
    return mod


def _script_defs(script: str, names, **consts):
    """Execute the statements of ``script``'s ``main`` that define ``names``
    (functions or assignments) in a namespace holding ``consts`` -> it."""
    with open(os.path.join(REPO, "scripts", script)) as f:
        tree = ast.parse(f.read())
    main = next(n for n in tree.body if isinstance(n, ast.FunctionDef) and n.name == "main")
    picked = []
    for node in main.body:
        if isinstance(node, ast.FunctionDef) and node.name in names:
            picked.append(node)
        elif (isinstance(node, ast.Assign) and len(node.targets) == 1
              and isinstance(node.targets[0], ast.Name) and node.targets[0].id in names):
            picked.append(node)
    assert {getattr(n, "name", None) or n.targets[0].id for n in picked} == set(names)
    ns = dict(jax=jax, jnp=jnp, lax=lax, pl=_interpret_pl(), pltpu=pltpu, functools=functools,
              **consts)
    exec(compile(ast.Module(body=picked, type_ignores=[]), script, "exec"), ns)
    return ns


def _bits(x) -> np.ndarray:
    """The raw bits of a bf16/f32 array (numpy or torch) for an exact check."""
    if isinstance(x, torch.Tensor):
        return (x.view(torch.int16) if x.dtype == torch.bfloat16 else x.view(torch.int32)).numpy()
    x = np.asarray(x)
    return x.view(np.int16) if x.dtype.itemsize == 2 else x.view(np.int32)


# ------------------------------------------------------------------ #
# P1a, P1b: scripts/pallas_launch_probe.py
# ------------------------------------------------------------------ #


def test_add_one_matches_tiny_kernel():
    ns = _script_defs("pallas_launch_probe.py", {"tiny_kernel"})
    x = np.random.RandomState(0).randn(8, 128).astype(np.float32)
    want = pl.pallas_call(ns["tiny_kernel"], out_shape=jax.ShapeDtypeStruct((8, 128), jnp.float32),
                          interpret=True)(jnp.asarray(x))
    before = probes.add_one.launches
    got = probes.add_one(torch.from_numpy(x))
    assert probes.add_one.launches == before  # CPU: the plain version
    np.testing.assert_array_equal(_bits(got), _bits(want))
    np.testing.assert_array_equal(_bits(probes.add_one_reference(torch.from_numpy(x))),
                                  _bits(want))


@pytest.mark.parametrize("n,offset", [(1023, 0), (4097, 0), (1024, 1), (1023, 3)])
def test_add_one_odd_n_and_offset_view_match_tiny_kernel(n, offset):
    """n not a multiple of 4 (the card kernel's scalar tail) and a view
    ``offset`` float32 values into its buffer (off a 16-byte boundary: the
    card kernel's scalar path), bit-equal to the Pallas kernel on n values."""
    ns = _script_defs("pallas_launch_probe.py", {"tiny_kernel"})
    buf = np.random.RandomState(n).randn(n + offset).astype(np.float32)
    want = pl.pallas_call(ns["tiny_kernel"], out_shape=jax.ShapeDtypeStruct((n,), jnp.float32),
                          interpret=True)(jnp.asarray(buf[offset:]))
    x = torch.from_numpy(buf)[offset:]
    assert x.is_contiguous() and x.storage_offset() == offset
    got = probes.add_one(x)
    np.testing.assert_array_equal(_bits(got), _bits(want))


# the TPU probe's kernel at L=3 layers, 2 windows, batch 4 (its widths: 40
# heads of 64, 128-token windows, rows [0, 2) copied)
P1B = dict(L=3, NW=2, B=4, N=40, D=64, W=128)


def test_decode_convention_matches_conv_kernel():
    """bf16(q + bf16(scales[li, 0, 0, 0, 0, 0])) for every layer li, bit for
    bit, under the script's own PrefetchScalarGridSpec and async copies."""
    c = P1B
    ns = _script_defs("pallas_launch_probe.py", {"conv_kernel", "grid_spec", "call"},
                      hb=c["N"], rb=probes.ROWS, **c)
    rng = np.random.RandomState(1)
    kv = rng.randint(-128, 128, (c["L"], c["NW"], c["B"], 2, c["N"], c["D"], c["W"]))
    kv = kv.astype(np.int8)
    # scales spread over magnitudes, so their bf16 rounding and the bf16 sum
    # both round
    sc = (rng.randn(c["L"], c["NW"], c["B"], 2, c["N"], c["W"])
          * 10.0 ** rng.randint(-3, 3, (c["L"], c["NW"], c["B"], 2, c["N"], c["W"])))
    sc = sc.astype(np.float32)
    q = jnp.asarray(rng.randn(c["B"], c["N"], c["D"]).astype(np.float32)).astype(jnp.bfloat16)
    tq = torch.from_numpy(np.array(q.astype(jnp.float32))).to(torch.bfloat16)
    ring = torch.zeros((8, c["B"], c["N"], 2 * c["D"]))
    tkv, tsc = torch.from_numpy(kv), torch.from_numpy(sc)
    for li in range(c["L"]):
        (want,) = ns["call"](jnp.array([li, 0], jnp.int32), q, jnp.asarray(kv), jnp.asarray(sc))
        got = probes.decode_convention(tq, ring, tkv[li], tsc[li], 0)
        assert got.dtype == torch.bfloat16 and got.shape == tuple(want.shape)
        np.testing.assert_array_equal(_bits(got), _bits(want))
        assert not torch.equal(got, tq)  # the scale changed q


def test_decode_convention_rounds_the_scale_then_the_sum():
    """The plain version rounds the scale to bf16 before the add (one
    rounding of the float32 sum would give another value here), and keeps
    float32 for a float32 q."""
    q = torch.full((2, 1, 4), 1.0, dtype=torch.bfloat16)
    kv = torch.zeros((1, 2, 2, 1, 4, 128), dtype=torch.int8)
    sc = torch.zeros((1, 2, 2, 1, 128))
    sc[0, 0, 0, 0, 0] = 2.0 ** -8 + 2.0 ** -16  # bf16: 2^-8; 1 + 2^-8 ties to 1
    ring = torch.zeros((8, 2, 1, 8))
    got = probes.decode_convention(q, ring, kv, sc, 0)
    assert torch.equal(got, q)
    assert (q.float() + sc[0, 0, 0, 0, 0]).to(torch.bfloat16)[0, 0, 0].item() > 1.0
    got32 = probes.decode_convention(q.float(), ring, kv, sc, 0)
    assert got32.dtype == torch.float32 and torch.equal(got32, q.float() + sc[0, 0, 0, 0, 0])


# ------------------------------------------------------------------ #
# P2: scripts/seal_scatter_probe.py
# ------------------------------------------------------------------ #


SEAL = dict(G=8, hb=40, Dc=64, W=128)


@pytest.mark.parametrize("variant", ["v_accum", "v_bigsum", "v_fused2d", "v_serial"])
def test_seal_scatter_matches_each_lowering(variant):
    """The port's one kernel against each TPU lowering that traces, on the
    probe's inputs (lane0 = 16) and three random (lane0, one-hot) pairs."""
    ns = _script_defs("seal_scatter_probe.py", {"make", variant}, **SEAL)
    call = ns["make"](ns[variant])
    qc, oh, l0 = ssp.probe_inputs()
    rng = np.random.RandomState(7)
    cases = [(qc, oh, l0)]
    for lane0 in rng.randint(0, 121, 3):
        qc_r = torch.from_numpy(rng.randint(-127, 127, (8, 40, 64)).astype(np.float32))
        cases.append((qc_r, ssp.one_hot(int(lane0)),
                      torch.full((1, 1), int(lane0), dtype=torch.int32)))
    for qc_c, oh_c, l0_c in cases:
        want = np.asarray(call(jnp.asarray(qc_c.numpy()), jnp.asarray(oh_c.numpy()),
                               jnp.asarray(l0_c.numpy())))
        got = probes.seal_scatter(qc_c, oh_c, l0_c)
        assert got.dtype == torch.int8 and got.shape == (40, 64, 128)
        np.testing.assert_array_equal(got.numpy(), want)
        lane0 = int(l0_c)
        assert np.count_nonzero(want[:, :, :lane0]) == 0
        assert np.count_nonzero(want[:, :, lane0 + 8:]) == 0


def test_seal_scatter_truncates_toward_zero():
    qc = torch.zeros((8, 1, 4))
    qc[0, 0] = torch.tensor([2.7, -2.7, 126.9, -0.5])
    l0 = torch.zeros((1, 1), dtype=torch.int32)
    out = probes.seal_scatter(qc, ssp.one_hot(0), l0)
    assert out[0, :, 0].tolist() == [2, -2, 126, 0]


def test_wrappers_raise_on_an_unsupported_device():
    x = torch.zeros((8, 128), device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        probes.add_one(x)
    with pytest.raises(ValueError, match="unsupported device"):
        probes.seal_scatter(torch.zeros((8, 2, 4), device="meta"), x, x)


# ------------------------------------------------------------------ #
# the entry points on the CPU
# ------------------------------------------------------------------ #


def test_launch_probe_chains_on_cpu(capsys):
    iters = 7
    x = lp.tiny_chain(torch.zeros((8, 128)), iters)
    assert x.sum().item() == 1024 * iters
    res = lp.run(torch.device("cpu"), iters=iters, reps=1, shape=(3, 2, 2, 4, 64, 128))
    for name in ("tiny", "torch_add", "convention"):
        assert res[name]["graph_us"] is None and math.isfinite(res[name]["eager_us"])
        assert res[name]["graph_captured"] == res[name]["graph_replayed"] == 0
    assert res["convention"]["plain_graph_us"] is None
    assert res["convention"]["max_abs_err"] == 0
    out = capsys.readouterr().out
    assert "decode-convention 1 window eager" in out
    assert "decode-convention layers (0, 1, 2): bit-equal" in out


def test_convention_chain_reads_layer_i_mod_L():
    """Call i adds layer (i % L)'s first scale: after 5 calls over 3 layers,
    q = ((q + s0) + s1) + s2) + s0) + s1, in bf16."""
    q, ring, kv, sc = lp.convention_inputs(torch.device("cpu"), (3, 2, 2, 4, 64, 128), seed=3)
    got = lp.convention_chain(q, ring, kv, sc, 5)
    want = q
    for li in (0, 1, 2, 0, 1):
        want = want + sc[li, 0, 0, 0, 0, 0].to(torch.bfloat16)
    assert torch.equal(got, want)


def test_seal_scatter_probe_on_cpu(capsys):
    res = ssp.run(torch.device("cpu"), iters=3, reps=1)
    assert res["pass"] and res["graph_us"] is None
    assert res["kernel_graph_us"] is None and res["plain_graph_us"] is None
    assert res["graph_captured"] == res["graph_replayed"] == 0
    qc, oh, l0 = ssp.probe_inputs()
    acc = ssp.seal_loop(qc, oh, l0, 3)
    # lane 16 + g of head h < 8 sums column g's value three times
    assert torch.equal(acc[:, :, 16:24], 3 * qc[:, :8].permute(1, 2, 0).int())
    assert torch.count_nonzero(acc[:, :, :16]) + torch.count_nonzero(acc[:, :, 24:]) == 0
    assert "seal PASS" in capsys.readouterr().out


def test_decode_kernel_sweep_on_cpu():
    """The sweep on a small seeded cache with cogview-base's 9 windows (two
    layers, one head of 64): five points, each checked, and a finite line."""
    cfg = tiny_test(kv_cache_dtype="int8", num_heads=1)
    cache = dkm.seeded_cache(cfg, 1, 1089, torch.device("cpu"))
    assert cache.kv.shape[1] == 9
    assert cache.kv.float().std() > 50 and 0 < cache.scale.min() <= cache.scale.max() < 0.02
    gen = torch.Generator().manual_seed(0)
    q = torch.randn((1, 1, 64), generator=gen).to(torch.bfloat16)
    cols = torch.randn((1, 1, 128), generator=gen)
    rows = dkm.sweep(torch.device("cpu"), cache, q, cols, iters=2, ring_write=True,
                     max_len=1089, reps=1)
    assert [r["index"] for r in rows] == [64, 320, 576, 832, 1088]
    assert all(r["index"] % 8 != 7 for r in rows)
    assert all(r["max_abs_err"] == 0 and r["graph_replayed"] == 0 for r in rows)
    res = dkm.summarize(rows, 1, 1, 64, "int8")
    assert res["graph"] is None
    assert math.isfinite(res["eager"]["slope_us"]) and math.isfinite(res["eager"]["intercept_us"])
    # the ring slot of layer 1 holds the written columns
    assert torch.equal(cache.recent[1, 0], cols)


@pytest.mark.parametrize("kv", ["int8", "int4"])
def test_sweep_check_sees_a_wrong_window_or_layer(kv):
    """On the seeded cache, ctx from another layer, or from the index one
    window earlier, fails the sweep's check against the plain version; the
    plain version's own ctx passes it."""
    cfg = tiny_test(kv_cache_dtype=kv, num_heads=2)
    cache = dkm.seeded_cache(cfg, 2, 1089, torch.device("cpu"))
    q = torch.randn((2, cfg.num_heads, cfg.head_dim),
                    generator=torch.Generator().manual_seed(1)).to(torch.bfloat16)
    index = 1088
    own = dkm.decode_calls(q, cache.recent[1, 0], cache, index, 2, ring_write=False)
    assert dkm.check(own, q, cache, index, 1) == 0
    for layer, at in ((0, index), (1, index - 128)):
        wrong = dkm.decode_calls(q, None, cache, at, layer + 1, ring_write=False)
        with pytest.raises(SystemExit, match="differs from the plain version"):
            dkm.check(wrong, q, cache, index, 1)


@pytest.mark.parametrize("module", [lp, ssp, dkm])
def test_entry_points_refuse_to_run_without_a_card(module, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit) as e:
        module.main(["--iters", "1"])
    assert e.value.code not in (0, None)
