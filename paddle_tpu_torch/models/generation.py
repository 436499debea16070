"""Decoding strategies over the dense KV cache (counterpart of the
reference's ``models/generation.py``): greedy, temperature / top-k /
top-p sampling with a repetition penalty, beam search, and speculative
decoding with a draft model, all on a model's ``init_cache`` and
``decode_step``.

Every strategy keeps its step state on the device: the greedy and
sampling loops and beam search read nothing back to the host until the
end. Speculative decoding reads each round's proposals and acceptance
once, as the reference does.

``use_jit=True`` (greedy, sampling and beams, as in the reference) wraps
``model.decode_step`` in ``jit.to_static`` once a call: on the card the
decode step runs as a captured CUDA graph (the prefill, called once, is
recorded and never captured). The position is then one int32 device
tensor refilled in place every step, and beam search re-indexes the
caches in place, so the compiled step always writes the caches it
captured and never copies them; the ids and the position are copied
into the graph's own buffers each step. The host checks that the
positions fit the cache (the device position is never read there).
Sampling stays outside the compiled step, as in the reference.

Randomness comes from an explicit ``generator`` (a ``torch.Generator``
on the model's device; torch's default one when None) where the
reference draws a framework key, so draws differ from the reference's;
everything that is not a draw matches it.
"""
from __future__ import annotations

import torch


def _apply_repetition_penalty(logits, seen_mask, penalty):
    """HF semantics: the scores of tokens in ``seen_mask`` are divided by
    ``penalty`` when positive, multiplied when negative."""
    pen = torch.where(logits > 0, logits / penalty, logits * penalty)
    return torch.where(seen_mask, pen, logits)


def _filter_top_k_top_p(logits, top_k, top_p):
    """-inf outside the top-k (ties at the k-th value kept) and outside
    the nucleus: a token stays while the mass before it (in descending
    order) is below ``top_p``, so the best token always stays."""
    v = logits.shape[-1]
    if top_k and top_k > 0:
        kth = torch.topk(logits, min(int(top_k), v), dim=-1).values[..., -1:]
        logits = logits.masked_fill(logits < kth, float("-inf"))
    if top_p is not None and top_p < 1.0:
        sorted_l = torch.sort(logits, dim=-1, descending=True).values
        probs = torch.softmax(sorted_l, dim=-1)
        cum = torch.cumsum(probs, dim=-1)
        keep_sorted = (cum - probs) < top_p
        cutoff = torch.where(keep_sorted, sorted_l, float("inf")).amin(
            dim=-1, keepdim=True)
        logits = logits.masked_fill(logits < cutoff, float("-inf"))
    return logits


def _step_sample(logits_last, seen_mask, generator, *, do_sample,
                 temperature, top_k, top_p, repetition_penalty):
    """The next token of each row from its last logits [B, V]: the
    first argmax, or with ``do_sample`` a draw from the penalised,
    tempered and filtered distribution."""
    lg = logits_last.float()
    if repetition_penalty and repetition_penalty != 1.0:
        lg = _apply_repetition_penalty(lg, seen_mask, repetition_penalty)
    if not do_sample:
        return torch.argmax(lg, dim=-1)
    if temperature and temperature != 1.0:
        lg = lg / temperature
    lg = _filter_top_k_top_p(lg, top_k, top_p)
    return torch.multinomial(torch.softmax(lg, dim=-1), 1,
                             generator=generator)[:, 0]


def _input_ids(model, input_ids):
    ids = torch.as_tensor(input_ids, device=model.device)
    if ids.dtype.is_floating_point or ids.dim() != 2:
        raise ValueError("input_ids must be integer token ids [B, S]")
    return ids


def generate(model, input_ids, max_new_tokens=32, do_sample=False,
             temperature=1.0, top_k=0, top_p=1.0,
             repetition_penalty=1.0, eos_token_id=None, num_beams=1,
             length_penalty=1.0, use_jit=False, generator=None):
    """Decode ``max_new_tokens`` from a causal LM with ``init_cache`` and
    ``decode_step``. Greedy by default; ``do_sample=True`` draws with
    ``temperature`` / ``top_k`` / ``top_p`` from ``generator``;
    ``repetition_penalty`` counts the prompt's tokens as seen;
    ``num_beams > 1`` runs beam search (deterministic: ``do_sample``
    must be False). After ``eos_token_id`` a row keeps emitting it.
    Returns [B, S0 + max_new_tokens] (the best beam for beam search)."""
    if num_beams > 1:
        if do_sample:
            raise ValueError(
                "generate: num_beams > 1 with do_sample=True is not "
                "supported (beam search is deterministic)")
        return _beam_search(
            model, input_ids, max_new_tokens, num_beams,
            eos_token_id=eos_token_id, length_penalty=length_penalty,
            repetition_penalty=repetition_penalty, use_jit=use_jit)
    with torch.no_grad():
        ids = _input_ids(model, input_ids)
        b, s0 = ids.shape
        caches = model.init_cache(b, s0 + max_new_tokens)
        step = _Stepper(model, caches, use_jit)
        need_seen = bool(repetition_penalty) and repetition_penalty != 1.0
        seen = None
        if need_seen:
            seen = torch.zeros(b, model.config.vocab_size, dtype=torch.bool,
                               device=ids.device)
            seen.scatter_(1, ids.long(), True)
        done = torch.zeros(b, dtype=torch.bool, device=ids.device)
        rows = torch.arange(b, device=ids.device)
        tokens, cur = [ids], ids
        for i in range(max_new_tokens):
            logits = step(cur, 0 if i == 0 else s0 + i - 1)
            nxt = _step_sample(
                logits[:, -1], seen, generator, do_sample=do_sample,
                temperature=temperature, top_k=top_k, top_p=top_p,
                repetition_penalty=repetition_penalty)
            if eos_token_id is not None:
                nxt = nxt.masked_fill(done, eos_token_id)
                done |= nxt == eos_token_id
            if need_seen:
                seen[rows, nxt] = True
            cur = nxt[:, None].to(ids.dtype)
            tokens.append(cur)
        return torch.cat(tokens, dim=1)


class _Stepper:
    """``model.decode_step`` over ``caches`` a step, eager (an int
    position, a new ids tensor each step) or with ``use_jit`` compiled
    (``jit.to_static``, once a call as the reference's ``generate``): the
    position is one int32 device tensor refilled in place, so the
    compiled decode step reads it on the device. The positions are
    checked against the cache on the host, where they are ints."""

    def __init__(self, model, caches, use_jit):
        self.model, self.caches = model, caches
        self.fn = model.decode_step
        self.pos = None
        if use_jit:
            from .. import jit

            self.fn = jit.to_static(model.decode_step)
            self.pos = torch.zeros((), dtype=torch.int32,
                                   device=caches[0][0].device)

    def __call__(self, ids, pos):
        """The logits of ``ids`` at positions [pos, pos + S)."""
        if self.pos is None:
            logits, _ = self.fn(ids, self.caches, pos)
            return logits
        smax = self.caches[0][0].shape[1]
        if pos < 0 or pos + ids.shape[1] > smax:
            raise ValueError(f"decode_step: positions [{pos}, "
                             f"{pos + ids.shape[1]}) do not fit the "
                             f"cache's {smax} slots")
        self.pos.fill_(pos)
        logits, _ = self.fn(ids, self.caches, self.pos)
        return logits


def _spec_accept_core(p_logits, proposals, q_probs, u, temperature):
    """The deterministic half of the sampled acceptance rule
    (Leviathan et al. / Chen et al.): with the uniforms ``u`` [k],
    proposal ``x_j`` is accepted while ``u_j < p_j(x_j) / q_j(x_j)``.
    Returns ``(n_acc, dist)``: the accepted count (0-dim) and the
    distribution [V] of the token that follows them, ``norm(max(p - q,
    0))`` at the first rejection and ``p_{k+1}`` after k acceptances.

    p_logits: [k + 1, V] target logits over the verify window;
    proposals: [k] draft tokens; q_probs: [k, V] the draft's tempered
    distributions."""
    k = proposals.shape[0]
    p = torch.softmax(p_logits.float() / temperature, dim=-1)
    idx = proposals.long()[:, None]
    p_sel = p[:k].gather(1, idx)[:, 0]
    q_sel = q_probs.gather(1, idx)[:, 0]
    accept = u < p_sel / q_sel.clamp_min(1e-20)
    n_acc = torch.cumprod(accept.int(), dim=0).sum()
    p_at = p[n_acc]
    q_at = torch.cat([q_probs, q_probs.new_zeros(1, q_probs.shape[1])])[n_acc]
    resid = (p_at - q_at).clamp_min(0.0)
    total = resid.sum()
    dist = torch.where(total > 0, resid / total.clamp_min(1e-20), p_at)
    return n_acc, dist


def _spec_accept_sampled(p_logits, proposals, q_probs, generator,
                         temperature):
    """Sampled acceptance on the device: ``u`` and the final token drawn
    from ``generator``. The output is distributed exactly as sampling
    the target alone. Returns ``(n_acc, tokens [k + 1])``: the accepted
    proposals, then the final token at ``n_acc``."""
    k = proposals.shape[0]
    u = torch.rand(k, generator=generator, device=p_logits.device)
    n_acc, dist = _spec_accept_core(p_logits, proposals, q_probs, u,
                                    temperature)
    final = torch.multinomial(dist, 1, generator=generator)
    toks = torch.cat([proposals, proposals.new_zeros(1)])
    toks[n_acc] = final.to(toks.dtype)[0]
    return n_acc, toks


def speculative_generate(model, draft_model, input_ids,
                         max_new_tokens=32, draft_k=4,
                         eos_token_id=None, return_stats=False,
                         do_sample=False, temperature=1.0,
                         generator=None):
    """Speculative decoding: ``draft_model`` proposes ``draft_k`` tokens
    one at a time, ``model`` verifies them in one ``decode_step``.
    Greedy: the longest prefix matching the target's argmax is accepted,
    plus the target's own next token, so the output equals ``model``'s
    greedy decoding token for token. ``do_sample=True``: proposals are
    drawn from the draft's tempered distribution and accepted by the
    sampled rule (:func:`_spec_accept_sampled`).

    Rejected slots of either cache need no rollback: the next window
    always overwrites them before a mask exposes them. Each round first
    feeds the draft the committed tokens it has not consumed (the bonus
    token, and after a full acceptance the last proposal too). Batch
    size must be 1 (one cache position for the batch). Returns [1, S0 +
    n] (stops early after eos), and with ``return_stats`` the target
    call count beside it."""
    ids = _input_ids(model, input_ids)
    b, s0 = ids.shape
    if b != 1:
        raise ValueError(
            "speculative_generate supports batch_size=1 (per-row "
            "acceptance lengths would desync the cache position); got "
            f"batch {b}")
    if draft_k < 1:
        raise ValueError(f"draft_k must be >= 1, got {draft_k}")
    if max_new_tokens <= 0:
        return (ids, {"target_calls": 0, "tokens": 0,
                      "tokens_per_target_call": 0.0}) \
            if return_stats else ids
    temperature = float(temperature)
    if do_sample and temperature <= 0:
        raise ValueError("do_sample needs temperature > 0")

    def pick(logits_last):
        """The next token [1] from last-position logits [1, V], and with
        ``do_sample`` the tempered distribution it was drawn from."""
        if not do_sample:
            return torch.argmax(logits_last, dim=-1), None
        q = torch.softmax(logits_last.float() / temperature, dim=-1)
        return torch.multinomial(q, 1, generator=generator)[:, 0], q

    with torch.no_grad():
        dev = ids.device
        max_len = s0 + max_new_tokens + draft_k + 1
        t_caches = model.init_cache(1, max_len)
        d_caches = draft_model.init_cache(1, max_len)
        t_logits, t_caches = model.decode_step(ids, t_caches, 0)
        _, d_caches = draft_model.decode_step(ids, d_caches, 0)
        out = [int(pick(t_logits[:, -1])[0])]
        n_target_calls = 1
        d_next = s0  # the first draft-cache position not yet written

        while len(out) < max_new_tokens and (
                eos_token_id is None or out[-1] != eos_token_id):
            base = s0 + len(out) - 1  # the position of out[-1]
            catchup = out[d_next - s0:base + 1 - s0]
            dl, d_caches = draft_model.decode_step(
                torch.tensor([catchup], dtype=ids.dtype, device=dev),
                d_caches, d_next)
            tok, q = pick(dl[:, -1])
            props, qs = [tok], [q]
            for j in range(1, draft_k):
                dl, d_caches = draft_model.decode_step(
                    tok[:, None].to(ids.dtype), d_caches, base + j)
                tok, q = pick(dl[:, -1])
                props.append(tok)
                qs.append(q)
            prop_dev = torch.cat(props)
            proposal = prop_dev.tolist()
            window = torch.tensor([[out[-1]] + proposal], dtype=ids.dtype,
                                  device=dev)
            tl, t_caches = model.decode_step(window, t_caches, base)
            n_target_calls += 1
            if do_sample:
                n_acc_d, toks_d = _spec_accept_sampled(
                    tl[0], prop_dev, torch.cat(qs), generator, temperature)
                n_acc = int(n_acc_d)
                toks = toks_d.tolist()
                accepted = toks[:n_acc]
                # eos inside the accepted prefix ends the output there
                if eos_token_id is not None and eos_token_id in accepted:
                    n_acc = accepted.index(eos_token_id) + 1
                    accepted = accepted[:n_acc]
                else:
                    accepted.append(toks[n_acc])
            else:
                # preds[j]: the target's next token after window[:j + 1]
                preds = torch.argmax(tl[0], dim=-1).tolist()
                n_acc = 0
                while (n_acc < draft_k
                       and proposal[n_acc] == preds[n_acc]):
                    n_acc += 1
                    if proposal[n_acc - 1] == eos_token_id:
                        break
                accepted = proposal[:n_acc]
                if not accepted or accepted[-1] != eos_token_id:
                    accepted.append(preds[n_acc])  # the bonus token
            out.extend(accepted[:max_new_tokens - len(out)])
            # the draft wrote through base + k - 1; a rejection
            # invalidates from the bonus position base + n_acc + 1 on
            d_next = base + min(draft_k - 1, n_acc) + 1

        result = torch.cat([ids, torch.tensor([out], dtype=ids.dtype,
                                              device=dev)], dim=1)
        if return_stats:
            return result, {
                "target_calls": n_target_calls,
                "tokens": len(out),
                "tokens_per_target_call": round(
                    len(out) / max(1, n_target_calls), 2),
            }
        return result


def _best_beam(generated, scores, lengths, b, k, length_penalty):
    """The best of each row's ``k`` beams by ``score / length **
    length_penalty`` over each beam's decoded length: ``(tokens [b, T],
    kept scores [b])``."""
    lens = lengths.reshape(b, k).clamp_min(1).float()
    sc = scores.reshape(b, k)
    pick = torch.argmax(sc / lens ** length_penalty, dim=-1)
    rows = torch.arange(b, device=generated.device)
    return generated.reshape(b, k, -1)[rows, pick], sc[rows, pick]


def _beam_search(model, input_ids, max_new_tokens, num_beams,
                 eos_token_id=None, length_penalty=1.0,
                 repetition_penalty=1.0, use_jit=False):
    """Fixed-width beam search: the prompt prefills once at B lanes, the
    caches and logits then expand to B * K lanes; each step takes the
    top K of K * V ``score + log_softmax`` per row (equal values lowest
    index first, as ``jax.lax.top_k``) and re-indexes the caches and
    the history onto the chosen lanes. A beam that emitted eos is
    frozen: it emits eos at zero cost and stops growing its length. The
    repetition penalty applies to the raw logits, with the prompt's
    tokens seen. The caches are re-indexed in place (``use_jit``: the
    compiled decode step keeps reading the buffers it captured). Returns
    [B, S0 + max_new_tokens], each row's best beam by
    :func:`_best_beam`."""
    with torch.no_grad():
        ids = _input_ids(model, input_ids)
        b, s0 = ids.shape
        k = int(num_beams)
        v = model.config.vocab_size
        dev = ids.device
        need_pen = bool(repetition_penalty) and repetition_penalty != 1.0
        caches = model.init_cache(b, s0 + max_new_tokens)
        step = _Stepper(model, caches, use_jit)
        logits = step(ids, 0)
        caches = step.caches = [(ck.repeat_interleave(k, dim=0),
                                 cv.repeat_interleave(k, dim=0))
                                for ck, cv in caches]
        last = logits[:, -1].repeat_interleave(k, dim=0)  # [B * K, V]

        scores = torch.tensor([0.0] + [-1e30] * (k - 1),
                              device=dev).repeat(b)
        alive = torch.ones(b * k, dtype=torch.bool, device=dev)
        lengths = torch.zeros(b * k, dtype=torch.long, device=dev)
        lanes_all = torch.arange(b * k, device=dev)
        seen = None
        if need_pen:
            seen = torch.zeros(b * k, v, dtype=torch.bool, device=dev)
            seen.scatter_(1, ids.long().repeat_interleave(k, dim=0), True)
        frozen = None
        if eos_token_id is not None:
            # a frozen beam may only emit eos, at zero cost
            frozen = torch.full((v,), -1e30, device=dev)
            frozen[eos_token_id] = 0.0
        generated = None  # [B * K, T]
        for i in range(max_new_tokens):
            if i > 0:
                last = step(cur, s0 + i - 1)[:, -1]
            lraw = last.float()
            if need_pen:
                lraw = _apply_repetition_penalty(lraw, seen,
                                                 repetition_penalty)
            lp = torch.log_softmax(lraw, dim=-1)
            if frozen is not None:
                lp = torch.where(alive[:, None], lp, frozen[None, :])
            total = (scores[:, None] + lp).reshape(b, k * v)
            # a stable descending sort: equal totals lowest index first
            top_sc, top_ix = torch.sort(total, dim=-1, descending=True,
                                        stable=True)
            top_sc, top_ix = top_sc[:, :k], top_ix[:, :k]
            tok = (top_ix % v).reshape(-1)
            lane = (torch.arange(b, device=dev)[:, None] * k
                    + top_ix // v).reshape(-1)
            alive_prev = alive[lane]
            lengths = lengths[lane] + alive_prev.long()
            alive = alive_prev
            if eos_token_id is not None:
                alive = alive & (tok != eos_token_id)
            if need_pen:
                seen = seen[lane]
                seen[lanes_all, tok] = True
            scores = top_sc.reshape(-1)
            cur = tok[:, None].to(ids.dtype)
            # the caches (in place) and the history onto the chosen lanes
            for ck, cv in caches:
                ck.copy_(ck.index_select(0, lane))
                cv.copy_(cv.index_select(0, lane))
            generated = cur if generated is None else torch.cat(
                [generated[lane], cur], dim=1)
        best, _ = _best_beam(generated, scores, lengths, b, k,
                             length_penalty)
        return torch.cat([ids, best], dim=1)
