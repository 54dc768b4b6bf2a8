"""Autoregressive template filling (twin of cogview_tpu/generation/sampling.py).

The template is compiled on the host into per-position arrays (fixed-token
mask, vocabulary-mask mode, position ids with the [ROI2] restart).  The
numpy template code is copied from the JAX package, which keeps it inside a
module that imports jax.

The decode loop is a host loop with one ``forward_with_cache`` call per
position from ctx to the last generated slot (:func:`decode_end`).  Each
step: temperature, the per-row BOI/EOI vocabulary mode, top-k / top-p by
threshold bisection, gumbel-max with counter-hash uniforms
``hash_uniform(seed, row, vocab_id, step)``, the ``fork_at`` lockstep, and
score accumulation.  From the same uint32 seed the port draws the same
noise as the JAX package.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Optional, Sequence, Tuple

import numpy as np
import torch

from ..config import GPTConfig
from ..models import gpt
from ..ops.hash_prng import hash_uniform
from ..parallel import comm
from ..parallel.mesh import DATA_AXIS, current_mesh

NEG_INF = -1e9

# vocabulary mask modes (per generated slot)
MODE_DEFAULT = 0  # text + commands (image codes forbidden)
MODE_IMAGE = 1  # image codes only
MODE_TEXT = 2  # text tokens only


@dataclasses.dataclass(frozen=True)
class SamplingParams:
    temperature: float = 1.0
    top_k: int = 200
    top_p: float = 0.0
    seed: int = 0


@dataclasses.dataclass
class Template:
    """Host-compiled generation template (static per-position metadata).

    ``tokens`` may be [S] or [B, S]; is_fixed/mask_id/position_ids are [S]."""

    tokens: np.ndarray  # [S] or [B, S] int32, -1 slots zeroed
    is_fixed: np.ndarray  # [S] bool
    mask_id: np.ndarray  # [S] int32 in {0,1,2}  (fixed-token modes)
    position_ids: np.ndarray  # [S] int32
    context_length: int
    mask_table: np.ndarray  # [3, V] bool  (True = allowed)
    boi_ids: np.ndarray = dataclasses.field(
        default_factory=lambda: np.full(2, -1, np.int32))  # [BOI1],[BOI2]
    eoi_ids: np.ndarray = dataclasses.field(
        default_factory=lambda: np.full(2, -1, np.int32))  # [EOI1],[EOI2]
    # fork-to-N: before ``fork_at`` every row draws its gumbel noise at
    # row-coordinate 0 and so samples the same tokens in lockstep
    fork_at: int = 0
    fork_n: int = 0

    @property
    def length(self) -> int:
        return int(self.tokens.shape[-1])


def build_mask_table(img_vocab: int, txt_vocab: int, padded_vocab: int) -> np.ndarray:
    V = padded_vocab
    n_real = img_vocab + txt_vocab + 27
    table = np.zeros((3, V), dtype=bool)
    table[MODE_DEFAULT, img_vocab:n_real] = True
    table[MODE_IMAGE, :img_vocab] = True
    table[MODE_TEXT, img_vocab : img_vocab + txt_vocab] = True
    return table


def compile_template_batch(
    seqs: Sequence[Sequence[int]],
    tokenizer,
    padded_vocab: int,
    pad_to: Optional[int] = None,
) -> Template:
    """Batch of templates sharing one slot pattern; tokens become [B, S]."""
    tpls = [compile_template(s, tokenizer, padded_vocab, pad_to) for s in seqs]
    first = tpls[0]
    for t in tpls[1:]:
        if not (
            np.array_equal(t.is_fixed, first.is_fixed)
            and np.array_equal(t.mask_id, first.mask_id)
            and np.array_equal(t.position_ids, first.position_ids)
            and (t.fork_at, t.fork_n) == (first.fork_at, first.fork_n)
        ):
            raise ValueError("templates in a batch must share one slot pattern")
    if first.fork_n:
        raise ValueError("fork markers fork ONE context; use a [S] template")
    return Template(
        np.stack([t.tokens for t in tpls]),
        first.is_fixed,
        first.mask_id,
        first.position_ids,
        first.context_length,
        first.mask_table,
        first.boi_ids,
        first.eoi_ids,
    )


def compile_template(
    seq: Sequence[int],
    tokenizer,
    padded_vocab: int,
    pad_to: Optional[int] = None,
) -> Template:
    """seq: ids with -1 generation slots (output of parse_query).

    ``pad_to`` appends fixed [PAD] steps up to that length."""
    seq = list(int(x) for x in seq)
    boi = {tokenizer["[BOI1]"], tokenizer["[BOI2]"]}
    eoi = {tokenizer["[EOI1]"], tokenizer["[EOI2]"]}
    roi2 = tokenizer["[ROI2]"]
    pad_id = tokenizer["[PAD]"]

    if pad_to is not None and pad_to > len(seq):
        seq = seq + [pad_id] * (pad_to - len(seq))

    S = len(seq)
    tokens = np.zeros(S, np.int32)
    is_fixed = np.zeros(S, bool)
    mask_id = np.zeros(S, np.int32)
    mode = MODE_DEFAULT
    offset = None
    context_length = 0
    seen_gen = False
    fork_at, fork_n = 0, 0
    for t, x in enumerate(seq):
        if x < -1:  # -N = fork-to-N marker on a generation slot
            if fork_n:
                raise ValueError("at most one fork marker per template")
            fork_at, fork_n = t, -x
            x = -1
        if x >= 0:
            # mode switches triggered by the fixed token itself
            if x in boi:
                mode = MODE_IMAGE
            elif x in eoi:
                mode = MODE_TEXT
            if x == roi2 and offset is None:
                offset = t
            tokens[t] = x
            is_fixed[t] = True
        else:
            seen_gen = True
        if not seen_gen:
            context_length = t + 1
        mask_id[t] = mode

    position_ids = np.arange(S, dtype=np.int32)
    if offset is not None and offset > 0:
        position_ids = np.where(
            position_ids > offset, position_ids - offset, position_ids
        ).astype(np.int32)

    table = build_mask_table(
        tokenizer.img_tokenizer.num_tokens, tokenizer.txt_tokenizer.num_tokens,
        padded_vocab,
    )
    return Template(
        tokens, is_fixed, mask_id, position_ids, context_length, table,
        np.asarray([tokenizer["[BOI1]"], tokenizer["[BOI2]"]], np.int32),
        np.asarray([tokenizer["[EOI1]"], tokenizer["[EOI2]"]], np.int32),
        fork_at, fork_n,
    )


def add_fork_marks(seq: Sequence[int], n: int) -> list:
    """Replace the first -1 slot of ``seq`` with a fork-to-n marker -n."""
    out = [int(x) for x in seq]
    for i, x in enumerate(out):
        if x == -1:
            out[i] = -int(n)
            return out
    raise ValueError("seq has no generation slots to fork at")


# --------------------------------------------------------------------- #
# logit filtering
# --------------------------------------------------------------------- #


_BISECT_ITERS = 26


def _bisect_threshold(logits: torch.Tensor, keep_ge: Any) -> torch.Tensor:
    """Per-row largest tau with keep_ge(logits, tau) True (keep_ge is
    monotone decreasing in tau), by 26 bisection steps -> [..., 1].  Sort
    free, as in the JAX package."""
    lo = logits.amin(dim=-1, keepdim=True)
    hi = logits.amax(dim=-1, keepdim=True)
    for _ in range(_BISECT_ITERS):
        mid = 0.5 * (lo + hi)
        ok = keep_ge(logits, mid)
        lo = torch.where(ok, mid, lo)
        hi = torch.where(ok, hi, mid)
    return lo


def apply_top_k(logits: torch.Tensor, k: int) -> torch.Tensor:
    """Keep the k largest logits per row, via threshold bisection."""
    if k <= 0 or k >= logits.shape[-1]:
        return logits

    def keep_ge(lg, tau):
        return (lg >= tau).sum(dim=-1, keepdim=True) >= k

    tau = _bisect_threshold(logits, keep_ge)
    return torch.where(logits < tau, NEG_INF, logits)


def apply_top_p(logits: torch.Tensor, p: float) -> torch.Tensor:
    """Nucleus filtering: keep the smallest set of highest-probability
    tokens whose mass reaches p (the crossing token is kept)."""
    if p <= 0.0:
        return logits
    z = logits - logits.amax(dim=-1, keepdim=True)
    ez = torch.exp(z)
    total = ez.sum(dim=-1, keepdim=True)

    def keep_ge(lg, tau):
        mass = torch.where(z >= tau, ez, 0.0).sum(dim=-1, keepdim=True)
        return mass >= p * total

    tau = _bisect_threshold(z, keep_ge)
    return torch.where(z < tau, NEG_INF, logits)


# --------------------------------------------------------------------- #
# the filling loop
# --------------------------------------------------------------------- #


def _validate_fill(cfg: GPTConfig, template: Template, batch_size: int) -> int:
    """The up-front guards of the JAX package -> resolved batch_size."""
    if template.fork_n > 1:
        if batch_size not in (1, template.fork_n):
            raise ValueError(
                f"template forks to {template.fork_n} but batch_size={batch_size}")
        batch_size = template.fork_n
    if template.tokens.ndim == 2 and template.tokens.shape[0] != batch_size:
        raise ValueError(
            f"batched template rows {template.tokens.shape[0]} != batch_size {batch_size}")
    max_pos = int(template.position_ids.max())
    if max_pos >= cfg.max_position_embeddings:
        raise ValueError(
            f"template needs position {max_pos} but the model has only "
            f"{cfg.max_position_embeddings} position embeddings")
    return batch_size


def decode_end(template: Template) -> int:
    """One past the last generated slot: the decode loop stops there.  The
    fixed slots after it (the [PAD] bucket) change neither the tokens nor
    the scores; the JAX loop steps through them."""
    ctx = int(template.context_length)
    free = np.flatnonzero(~np.asarray(template.is_fixed[ctx:]))
    return ctx + (int(free[-1]) + 1 if free.size else 0)


@torch.no_grad()
def filling_sequence(
    params,
    cfg: GPTConfig,
    template: Template,
    batch_size: int = 1,
    sampling: SamplingParams = SamplingParams(),
    seed_u32: int = 0,
    device=None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Fill a compiled template -> (tokens [B, S] int64, scores [B] float32).

    ``seed_u32`` is the uint32 seed of every gumbel draw; the JAX package
    derives its seed from a key as ``seed_from_key(rbg_key(key))``.  scores
    sum the log-probs of the sampled (non-fixed) tokens.

    Under a mesh (parallel/mesh.py) each data rank fills its rows of the
    batch, the model sharded as ``gpt.forward_with_cache`` is, and draws
    its gumbel noise at the rows' global ids; every rank returns the whole
    batch, gathered over 'data'."""
    B = _validate_fill(cfg, template, batch_size)
    S = template.length
    ctx = int(template.context_length)
    V = template.mask_table.shape[1]
    fork_at = int(template.fork_at)
    mesh = current_mesh()
    dp, dr = (1, 0) if mesh is None else (mesh.data, mesh.data_rank)
    if B % dp:
        raise ValueError(f"batch {B} does not split over data={dp}")
    Bl, b0 = B // dp, dr * (B // dp)  # this rank's rows [b0, b0 + Bl)

    cache = gpt.init_cache(cfg, Bl, S, device=device)
    tokens = torch.as_tensor(template.tokens, dtype=torch.int64, device=device)
    tokens = tokens.expand(B, S)[b0:b0 + Bl].clone()
    pos = torch.as_tensor(template.position_ids, dtype=torch.int64,
                          device=device).expand(Bl, S)
    mask_table = torch.as_tensor(template.mask_table, device=device)
    boi_ids = torch.as_tensor(template.boi_ids, dtype=torch.int64, device=device)
    eoi_ids = torch.as_tensor(template.eoi_ids, dtype=torch.int64, device=device)

    # prefill the fixed context; its last logits seed the first generated slot
    logits_ctx = gpt.forward_with_cache(params, cfg, tokens[:, :ctx], pos[:, :ctx],
                                        cache, 0)
    last_logits = logits_ctx[:, -1]

    # mode entering the first generated step = the fixed prefix's mode
    cur_mode = torch.full((Bl,), int(template.mask_id[max(ctx - 1, 0)]),
                          dtype=torch.int64, device=device)
    rows_all = b0 + torch.arange(Bl, dtype=torch.int64, device=device)[:, None]
    rows_zero = torch.zeros_like(rows_all)
    cols = torch.arange(V, dtype=torch.int64, device=device)[None, :]
    scores = torch.zeros((Bl,), dtype=torch.float32, device=device)

    for t in range(ctx, decode_end(template)):
        if template.is_fixed[t]:
            # the JAX step samples here too and then discards the draw
            # (where(fixed, template token, sampled); score += 0)
            tok_t = tokens[:, t]
        else:
            filtered = last_logits / sampling.temperature
            filtered = torch.where(mask_table[cur_mode], filtered, NEG_INF)
            filtered = apply_top_k(filtered, sampling.top_k)
            filtered = apply_top_p(filtered, sampling.top_p)
            # before the fork point every row draws at row-coordinate 0
            rows = rows_zero if (fork_at > ctx and t < fork_at) else rows_all
            u = hash_uniform(seed_u32, rows, cols, t)
            gumbel = -torch.log(-torch.log(u))
            tok_t = torch.argmax(filtered + gumbel, dim=-1)
            log_probs = torch.log_softmax(filtered, dim=-1)
            scores = scores + log_probs.gather(1, tok_t[:, None])[:, 0]
            tokens[:, t] = tok_t
        # a BOI/EOI token, fixed or sampled, switches every later slot's mode
        is_boi = (tok_t[:, None] == boi_ids[None, :]).any(dim=-1)
        is_eoi = (tok_t[:, None] == eoi_ids[None, :]).any(dim=-1)
        cur_mode = torch.where(is_boi, MODE_IMAGE, torch.where(is_eoi, MODE_TEXT, cur_mode))

        step_logits = gpt.forward_with_cache(params, cfg, tok_t[:, None],
                                             pos[:, t:t + 1], cache, t)
        last_logits = step_logits[:, 0]
    if dp > 1:
        tokens = comm.all_gather(tokens, DATA_AXIS, 0)
        scores = comm.all_gather(scores, DATA_AXIS, 0)
    return tokens, scores
