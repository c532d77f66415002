"""Speculative decoding's pure parts: host prompt-lookup drafting, the
engine's chain verify and the solo path's rejection sampling.

Twins of ``lambdipy_tpu/models/llama.py`` ``_lookup_draft`` (:1273),
``_lookup_draft_hit`` (:1289), ``_spec_chain_verify`` (:1215) and
``_spec_accept_resample`` (:1182). The device programs that run them
(the verify forward of ``b * kb`` one-token rows, the shallow-exit draft
chain) live in ``models/llama.py`` beside the decode step they share
buffers with.

Randomness differs by design: JAX walks a threefry key split per
selection; the port's sampled selection draws counter-based noise, a
function of the row's key and its draw index alone
(``models/llama.py stream_uniform``). So rolling a rejected tail back is
advancing the draw index by the accepted ``count``, on the device."""

from __future__ import annotations

import numpy as np
import torch


def lookup_draft_hit(context, k: int, ngram_max: int = 3) -> tuple:
    """Prompt-lookup drafting (host side): the ``k`` tokens that followed
    the most recent earlier occurrence of the context's suffix n-gram
    (longest first, at most ``ngram_max``), padded with the last token
    when the continuation runs short; ``(draft list of k, hit)``, where
    ``hit`` is False for the fallback (repeat the last token, or zeros on
    an empty context). A draft is only a proposal: a wrong one costs a
    verify position, never a wrong token."""
    ctx = np.asarray(context, np.int64).reshape(-1)
    n = ctx.size
    if n == 0:
        return [0] * k, False
    for g in range(min(ngram_max, n - 1), 0, -1):
        suffix = ctx[n - g:]
        windows = np.lib.stride_tricks.sliding_window_view(ctx, g)[:n - g]
        hits = np.nonzero((windows == suffix).all(axis=1))[0]
        if hits.size:
            start = int(hits[-1]) + g
            cand = ctx[start:start + k]
            out = np.full(k, ctx[-1], np.int64)
            out[:cand.size] = cand
            return out.tolist(), True
    return [int(ctx[-1])] * k, False


def lookup_draft(context, k: int, ngram_max: int = 3) -> list:
    """:func:`lookup_draft_hit`'s draft alone."""
    return lookup_draft_hit(context, k, ngram_max)[0]


def chain_verify(tgt, tlp, draft, lp_in):
    """The engine's accept/rollback core, on the chain's own selections:
    ``tgt``/``tlp`` ``[b, kb]`` are the token and raw logprob the row's
    select chain gives at each chunk position (position i selected with
    draw index ``draw + i``, exactly as the one-token step would),
    ``draft`` ``[b, kb - 1]`` the proposals (raw: a ``-1`` pad is never
    accepted), ``lp_in`` ``[b]`` the pending token's logprob. A draft is
    accepted while it equals the chain's token, so the emitted tokens are
    the spec-off engine's for greedy and seeded-sampled rows alike.

    Returns ``(lps_block [b, kb], count [b] in 1..kb, tok' [b], lp' [b])``:
    column 0 of ``lps_block`` is the pending token's logprob, column j the
    (j-1)'th selection's; the caller advances the row's position and draw
    index by ``count``."""
    kb = tgt.shape[1]
    ok = (tgt[:, :kb - 1] == draft).long()
    m = torch.cumprod(ok, dim=1).sum(dim=1)  # [b] 0..kb-1
    tok2 = tgt.gather(1, m[:, None])[:, 0]
    lp2 = tlp.gather(1, m[:, None])[:, 0]
    lps_block = torch.cat([lp_in[:, None], tlp[:, :kb - 1]], dim=1)
    return lps_block, m + 1, tok2, lp2


def accept_resample(probs, draft, u, gumbel):
    """The solo sampled path's rejection-sampling core (the
    delta-proposal case of speculative sampling), batched over rows:
    ``probs`` ``[b, kb, v]`` the target distributions per chunk position,
    ``draft`` ``[b, kb - 1]`` the proposals, ``u`` ``[b, kb - 1]`` one
    uniform per accept test, ``gumbel`` ``[b, v]`` Gumbel noise for the
    final draw. Position i accepts draft i with probability
    ``p_i(draft_i)``; the first rejection at m draws from the residual
    (``p_m`` with the rejected token zeroed, renormalized) and a full
    accept draws position ``kb - 1`` from ``p_{kb-1}``: ancestral sampling
    from the target chain. Returns ``(m [b] in 0..kb-1, new_tok [b])``."""
    b, kb, v = probs.shape
    p_draft = probs[:, :kb - 1].gather(2, draft[:, :, None])[:, :, 0]
    acc = (u < p_draft).long()
    m = torch.cumprod(acc, dim=1).sum(dim=1)
    pm = probs.gather(1, m[:, None, None].expand(b, 1, v))[:, 0]
    rejected = m < kb - 1
    dm = draft.gather(1, m.clamp(max=kb - 2)[:, None])[:, 0]
    zero = (torch.arange(v, device=probs.device)[None, :] == dm[:, None]) \
        & rejected[:, None]
    pm = torch.where(zero, 0.0, pm)
    pm = pm / pm.sum(dim=-1, keepdim=True).clamp(min=1e-30)
    new_tok = (torch.log(pm.clamp(min=1e-38)) + gumbel).argmax(dim=-1)
    return m, new_tok
