"""Batched CTC on the device: greedy and beam decoding, and the training
loss (port of ocrjax/ops/ctc.py)."""

from __future__ import annotations

from typing import Tuple

import torch


def _collapse_mask(ids: torch.Tensor, lengths: torch.Tensor, blank: int
                   ) -> torch.Tensor:
    """Keep frame t iff it is not blank, differs from frame t-1, and
    t < length. ids (B, T) int, lengths (B,) -> (B, T) bool."""
    B, T = ids.shape
    prev = torch.cat([torch.full((B, 1), -1, dtype=ids.dtype,
                                 device=ids.device), ids[:, :-1]], dim=1)
    t_idx = torch.arange(T, device=ids.device)[None, :]
    return (ids != blank) & (ids != prev) \
        & (t_idx < lengths.to(ids.device)[:, None])


def _compact(ids: torch.Tensor, keep: torch.Tensor, max_tokens: int
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Left-compact the kept ids into a (B, max_tokens) zero-padded buffer;
    a scatter where the reference uses a one-hot matmul (same result)."""
    B = ids.shape[0]
    keep_i = keep.to(torch.int32)
    pos = torch.cumsum(keep_i, dim=1) - 1
    # dropped frames and overflow go to a spare column that is cut off
    pos = torch.where(keep & (pos < max_tokens), pos, max_tokens)
    out = torch.zeros((B, max_tokens + 1), dtype=torch.int32,
                      device=ids.device)
    out.scatter_(1, pos.long(), ids.to(torch.int32) * keep_i)
    n_tokens = torch.clamp(keep_i.sum(dim=1), max=max_tokens).to(torch.int32)
    return out[:, :max_tokens], n_tokens


def ctc_greedy_decode(logits: torch.Tensor, lengths: torch.Tensor, *,
                      blank: int = 0, max_tokens: int = 128
                      ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """logits (B, T, C), lengths (B,) valid frames ->
    tokens (B, max_tokens) int32, n_tokens (B,) int32, confidence (B,)
    float32 = mean max-softmax prob over the kept frames (1.0 if none)."""
    logits = logits.float()
    ids = torch.argmax(logits, dim=-1).to(torch.int32)
    keep = _collapse_mask(ids, lengths, blank)
    tokens, n_tokens = _compact(ids, keep, max_tokens)
    frame_conf = torch.exp(torch.log_softmax(logits, dim=-1).amax(dim=-1))
    kept = keep.float()
    n_kept = kept.sum(dim=1)
    confidence = torch.where(
        n_kept > 0, (frame_conf * kept).sum(dim=1) / n_kept.clamp(min=1.0),
        torch.ones_like(n_kept))
    return tokens, n_tokens, confidence


NEG = -1e30   # log-mass of a disabled beam or candidate


def _beam_step(state, logp: torch.Tensor, t_valid: torch.Tensor, *,
               beam_width: int, blank: int):
    """One frame of the batched CTC prefix beam search.

    state: (p_b, p_nb (B, K) float32 log-mass of the prefix ending in a
    blank / a non-blank, last (B, K) last emitted id (-1 for none), toks
    (B, K, L) emitted ids, lens (B, K) emitted count); logp (B, V) this
    frame's log-probabilities; t_valid (B,) bool. Sequences whose frame is
    past their length keep their state (a select where the reference runs
    lax.cond under vmap, which is the same select). Prefix identity for the
    stay/extend merge is the exact (toks, len) comparison."""
    p_b, p_nb, last, toks, lens = state
    B, V = logp.shape
    K, L = beam_width, toks.shape[2]
    dev = logp.device
    p_tot = torch.logaddexp(p_b, p_nb)                        # (B, K)

    # stay: emit a blank, or repeat the last id without a gap
    stay_pb = p_tot + logp[:, blank, None]
    # last = -1 reads id V-1, as JAX's wrapping index does
    stay_pnb = p_nb + torch.gather(logp, 1, torch.remainder(last, V).long())

    # extend with id v != blank; v == last needs a blank before it
    char_ids = torch.arange(V, device=dev, dtype=last.dtype)
    is_last = char_ids[None, None, :] == last[..., None]      # (B, K, V)
    ext_pnb = torch.where(is_last, p_b[..., None], p_tot[..., None]) \
        + logp[:, None, :]
    ext_pnb = torch.where(char_ids == blank, NEG, ext_pnb)

    # merge: extend (parent k, id v) equals stay j iff len_j == len_k + 1,
    # their first len_k ids agree and stay j's id at slot len_k is v
    slot = torch.arange(L, device=dev)
    prefix_mask = slot < lens[..., None]                      # (B, K, L)
    prefix_eq = ((toks[:, :, None, :] == toks[:, None, :, :])
                 | ~prefix_mask[:, :, None, :]).all(dim=-1)   # (B, K, K)
    len_ok = (lens[:, :, None] + 1) == lens[:, None, :]
    at = torch.clamp(lens, 0, L - 1).long()                   # (B, K)
    at_lenk = torch.gather(toks, 2, at[:, None, :].expand(B, K, K)
                           ).transpose(1, 2)                  # [b, k, j]
    kj_ok = prefix_eq & len_ok
    match = kj_ok[:, :, None, :] & (
        at_lenk[:, :, None, :] == char_ids[None, None, :, None])  # (B,K,V,K)
    into = torch.where(match.reshape(B, K * V, K),
                       ext_pnb.reshape(B, K * V, 1), NEG)
    stay_pnb = torch.logaddexp(stay_pnb, torch.logsumexp(into, dim=1))
    ext_pnb = torch.where(match.any(dim=3), NEG, ext_pnb)

    # K stay candidates, then K*V extend candidates, in the reference's order
    cand_score = torch.cat([torch.logaddexp(stay_pb, stay_pnb),
                            ext_pnb.reshape(B, K * V)], dim=1)
    cand_pb = torch.cat([stay_pb, torch.full((B, K * V), NEG, device=dev)], 1)
    cand_pnb = torch.cat([stay_pnb, ext_pnb.reshape(B, K * V)], dim=1)
    cand_last = torch.cat([last, char_ids.repeat(K).expand(B, K * V)], dim=1)
    k_ids = torch.arange(K, device=dev)
    cand_src = torch.cat([k_ids, k_ids[:, None].expand(K, V).reshape(-1)])
    cand_ext = torch.cat([torch.zeros(K, dtype=torch.bool, device=dev),
                          torch.ones(K * V, dtype=torch.bool, device=dev)])

    # top K; a stable sort keeps tied scores in index order, as
    # jax.lax.top_k does (NEG + x == NEG, so exact ties are common)
    top_i = torch.sort(cand_score, dim=1, descending=True,
                       stable=True).indices[:, :K]
    n_pb = torch.gather(cand_pb, 1, top_i)
    n_pnb = torch.gather(cand_pnb, 1, top_i)
    n_last = torch.gather(cand_last, 1, top_i)
    src = cand_src[top_i]                                     # (B, K)
    is_ext = cand_ext[top_i]
    n_toks = torch.gather(toks, 1, src[..., None].expand(B, K, L))
    n_len = torch.gather(lens, 1, src)
    write = is_ext[..., None] & (slot == n_len[..., None]) \
        & (n_len[..., None] < L)
    n_toks = torch.where(write, n_last[..., None], n_toks)
    n_len = torch.where(is_ext & (n_len < L), n_len + 1, n_len)

    keep = ~t_valid
    return (torch.where(keep[:, None], p_b, n_pb),
            torch.where(keep[:, None], p_nb, n_pnb),
            torch.where(keep[:, None], last, n_last),
            torch.where(keep[:, None, None], toks, n_toks),
            torch.where(keep[:, None], lens, n_len))


def ctc_beam_decode(logits: torch.Tensor, lengths: torch.Tensor, *,
                    blank: int = 0, max_tokens: int = 128,
                    beam_width: int = 8
                    ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Batched fixed-width CTC prefix beam search on the logits' device.

    Same interface as ctc_greedy_decode; returns the best beam of each
    sequence, with confidence exp(score / max(n_tokens, 1)). The sequences
    are batched; the frames are a Python loop that reads nothing back to
    the host."""
    B, T, V = logits.shape
    K, L = beam_width, max_tokens
    dev = logits.device
    logp = torch.log_softmax(logits.float(), dim=-1)
    lengths = lengths.to(dev)
    # one empty beam in slot 0; the others disabled (their zero-length
    # prefixes never satisfy the merge's len_j == len_k + 1)
    p_b = torch.full((B, K), NEG, device=dev)
    p_b[:, 0] = 0.0
    state = (p_b, torch.full((B, K), NEG, device=dev),
             torch.full((B, K), -1, dtype=torch.int32, device=dev),
             torch.zeros((B, K, L), dtype=torch.int32, device=dev),
             torch.zeros((B, K), dtype=torch.int32, device=dev))
    for t in range(T):
        state = _beam_step(state, logp[:, t], t < lengths,
                           beam_width=K, blank=blank)
    p_b, p_nb, _, toks, lens = state
    score = torch.logaddexp(p_b, p_nb)
    best = torch.argmax(score, dim=1, keepdim=True)           # first maximum
    n_best = torch.gather(lens, 1, best)[:, 0]
    conf = torch.exp(torch.gather(score, 1, best)[:, 0]
                     / torch.clamp(n_best, min=1))
    tokens = torch.gather(toks, 1, best[..., None].expand(B, 1, L))[:, 0]
    return tokens, n_best, conf


# ---------------------------------------------------------------------------
# Loss (training)
# ---------------------------------------------------------------------------

LOG_EPSILON = -1e5     # optax's stand-in for log(0)


def ctc_loss_per_seq(logits: torch.Tensor, logit_lengths: torch.Tensor,
                     labels: torch.Tensor, label_lengths: torch.Tensor, *,
                     blank: int = 0) -> torch.Tensor:
    """(B,) negative log-likelihood of each label sequence: optax.ctc_loss's
    alpha recursion over blank-inserted labels, step for step.

    Not F.ctc_loss: that one divides by the target lengths under
    reduction="mean" and returns inf for an alignment that cannot exist
    (more labels than frames), where optax's log(0) is LOG_EPSILON, so an
    infeasible sample gives a large finite loss. logits (B, T, C);
    labels (B, U) padded; frames t >= logit_lengths and labels
    u >= label_lengths are padding."""
    B, T, _ = logits.shape
    U = labels.shape[1]
    dev = logits.device
    logp = torch.log_softmax(logits.float(), dim=-1)
    labels = labels.long().to(dev)
    pad_t = (torch.arange(T, device=dev)[None, :]
             >= logit_lengths.to(dev)[:, None]).float()        # (B, T)
    # repeat[b, n]: label n equals label n + 1 (no direct emit-emit step)
    repeat = torch.cat([(labels[:, :-1] == labels[:, 1:]).float(),
                        torch.zeros((B, 1), device=dev)], dim=1)
    lp_phi = logp[:, :, blank]                                  # (B, T)
    lp_emit = torch.gather(logp, 2, labels[:, None, :].expand(B, T, U))
    phi = torch.full((B, U + 1), LOG_EPSILON, device=dev)
    phi[:, 0] = 0.0
    emit = torch.full((B, U), LOG_EPSILON, device=dev)

    def add_phi(p, added):
        return torch.cat([p[:, :1], torch.logaddexp(p[:, 1:], added)], 1)

    for t in range(T):
        prev_phi_orig, prev_emit = phi, emit
        prev_phi = add_phi(phi, prev_emit + LOG_EPSILON * repeat)
        e_t = lp_emit[:, t]
        next_emit = torch.logaddexp(prev_phi[:, :-1] + e_t, prev_emit + e_t)
        next_phi = prev_phi + lp_phi[:, t:t + 1]
        next_phi = add_phi(next_phi, prev_emit + lp_phi[:, t:t + 1]
                           + LOG_EPSILON * (1.0 - repeat))
        pad = pad_t[:, t:t + 1]
        emit = pad * prev_emit + (1.0 - pad) * next_emit
        phi = pad * prev_phi_orig + (1.0 - pad) * next_phi
    last = add_phi(phi, emit)
    n = label_lengths.long().to(dev)
    return -torch.gather(last, 1, n[:, None])[:, 0]


def ctc_loss(logits: torch.Tensor, logit_lengths: torch.Tensor,
             labels: torch.Tensor, label_lengths: torch.Tensor, *,
             blank: int = 0) -> torch.Tensor:
    """Mean CTC loss over the batch: the plain mean of ctc_loss_per_seq,
    as ocrjax takes it (no division by the label lengths)."""
    return ctc_loss_per_seq(logits, logit_lengths, labels, label_lengths,
                            blank=blank).mean()
