"""Paged-cache serving adapter for LlamaForCausalLM (counterpart of the
reference's ``inference/paged_llama.py``).

The adapter exposes a ``LlamaForCausalLM`` through the BatchScheduler
model protocol (``alloc`` / ``free`` / ``decode_token`` /
``prefill_chunk`` / ``caches``), serving from one paged KV pool per
layer on the model's device. It reuses the model's own weights (no
copy): embed -> per layer (rms_norm kernel -> qkv -> RoPE at each
token's own position -> paged append + the ragged attention kernel ->
o_proj -> mlp) -> final norm -> LM head.

``kv_cache_dtype="int8"`` serves from int8 pages with per-page, per-head
scales (half the page bytes, so a byte budget holds about twice the
sequences). ``FLAGS_ragged_attention=off`` takes the historical
two-kernel routing: decode rows through the dedicated paged decode
kernel, prefill rows through the q_lens-masked ragged kernel.

The prefix-cache hooks (``attach_prefix``, ``seq_page_chains``) and the
preemption hooks (``swap_out``, ``swap_in``) act on every layer's pool
alike; the step's device inputs are built once from the first layer's
pool, so every pool must hold the same page tables, and each hook checks
that they do.

``sanitizer`` (``"off"``/``"warn"``/``"strict"``) overrides
``FLAGS_page_sanitizer`` for every layer's pool: each journals its
mutations and the page tables its kernel gets into a shadow heap
(``incubate/nn/page_sanitizer.py``).

``decode_window`` is the legacy speculative verify
(``FLAGS_spec_decode=legacy``): a w-token window per sequence through
one dense float32 masked attention over the gathered pages.

Not ported yet: weight-only quantized serving.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from ..device import copy_to_device
from ..framework.flags import ragged_attention_mode
from ..incubate.nn import PagedKVCacheManager
from ..ops.kernels.paged_attention import (
    packed_position_index as _packed_position_index,
)
from ..ops.kernels.rope import apply_rotary_emb, build_rope_cache

__all__ = ["PagedLlamaAdapter"]


def _pow2(n: int) -> int:
    return 1 << (max(int(n), 1) - 1).bit_length()


def _right_align_plan(row_indices, starts, counts, t_pad, rows_pad):
    """Host-built gather/scatter plan right-aligning each listed packed
    row into a (rows_pad, t_pad) block: ``gm`` gathers flat packed token
    indices into the block (row r's last counts[i] columns), and
    ``mr``/``mc``/``mflat`` map the kernel output back to flat packed
    slots. All host numpy."""
    gm = np.zeros((rows_pad, t_pad), np.int64)
    rr, cc, ff = [], [], []
    for r, i in enumerate(row_indices):
        c = int(counts[i])
        st = int(starts[i])
        gm[r, t_pad - c:] = np.arange(st, st + c)
        rr.append(np.full(c, r))
        cc.append(np.arange(t_pad - c, t_pad))
        ff.append(np.arange(st, st + c))
    return gm, *(np.concatenate(a).astype(np.int32) for a in (rr, cc, ff))


class PagedLlamaAdapter:
    """Serve a LlamaForCausalLM from a paged KV pool on the model's
    device. ``num_pages`` x ``page_size`` tokens per layer (or
    ``page_pool_bytes`` to size the pool by bytes: at a fixed budget an
    int8 ``kv_cache_dtype`` changes capacity, not spend); ``max_length``
    bounds RoPE positions."""

    def __init__(self, model, num_pages=256, page_size=16,
                 max_length=None, dtype=None, kv_cache_dtype=None,
                 weight_dtype=None, page_pool_bytes=None, sanitizer=None):
        if weight_dtype is not None:
            raise NotImplementedError(
                "weight-only quantized serving is not ported yet")
        self.model = model
        cfg = model.config
        self.cfg = cfg
        self.device = model.device
        self._window = int(getattr(cfg, "sliding_window", 0) or 0)
        if dtype is None:
            dtype = model.dtype
        self.max_length = int(max_length or cfg.max_position_embeddings)

        if page_pool_bytes is not None:
            per_page = PagedKVCacheManager.page_bytes(
                page_size, cfg.num_key_value_heads, cfg.head_dim,
                dtype=dtype, kv_dtype=kv_cache_dtype)
            num_pages = int(page_pool_bytes) // (
                cfg.num_hidden_layers * per_page)
            if num_pages < 1:
                raise ValueError(
                    f"page_pool_bytes={page_pool_bytes} cannot hold one "
                    f"page per layer ({cfg.num_hidden_layers} x "
                    f"{per_page} bytes)")
        self.caches = [
            PagedKVCacheManager(
                num_pages, page_size, cfg.num_key_value_heads,
                cfg.head_dim, dtype=dtype, kv_dtype=kv_cache_dtype,
                sanitizer=sanitizer, device=self.device)
            for _ in range(cfg.num_hidden_layers)
        ]
        self._cos, self._sin = build_rope_cache(
            self.max_length, cfg.head_dim, base=cfg.rope_theta,
            dtype=torch.float32, device=self.device)
        # chunked-prefill dispatch accounting: _dispatch_shapes holds the
        # distinct bucketed packed token counts prefill_chunk was fed;
        # _kernel_shapes the (kind, rows, T, max_pages[, bucket])
        # signatures of the padded attention calls underneath, and
        # _bucket_programs those signatures by bucket
        self._dispatch_shapes = set()
        self._kernel_shapes = set()
        self._bucket_programs = {}
        self._fused_ok = None
        self.chunk_stats = {"calls": 0, "packed_tokens": 0,
                            "padded_tokens": 0, "attend_calls": 0}

    @property
    def compile_count(self) -> int:
        """Distinct bucketed packed shapes the chunked step was fed (the
        reference's compiled-program count; the port runs eagerly, so
        here it counts shapes, bounded by the number of buckets)."""
        return len(self._dispatch_shapes)

    @property
    def attend_program_count(self) -> int:
        """Distinct padded attention-call signatures of the packed step:
        one per packed config under ``auto``/``on``, a decode and a
        prefill one for a mixed config under ``off``."""
        return len(self._kernel_shapes)

    @property
    def attend_kinds_by_bucket(self) -> dict:
        """Per packed bucket (pad_to): the sorted attention kernel kinds
        its steps launched — ``['ragged']`` or ``['ragged_fused']`` under
        the unified routing, ``['decode', 'prefill']`` on a mixed bucket
        under ``off``."""
        return {b: sorted({k for k, *_ in shapes})
                for b, shapes in self._bucket_programs.items()}

    def _note_program(self, pad_to, shape):
        self._kernel_shapes.add(shape)
        self._bucket_programs.setdefault(pad_to, set()).add(shape)

    def _fusion_eligible(self) -> bool:
        """Fused-step gate, computed once: the fused step writes float
        pages (an int8 pool calibrates per token) and consumes raw
        [in, out] q/k/v/o weights, so q/k/v biases must be all-or-none
        and o_proj bias-free."""
        if self._fused_ok is None:
            ok = not self.caches[0].quantized
            for layer in self.model.model.layers:
                att = layer.self_attn
                has = [p.bias is not None
                       for p in (att.q_proj, att.k_proj, att.v_proj)]
                if any(has) and not all(has):
                    ok = False
                if att.o_proj.bias is not None:
                    ok = False
            self._fused_ok = ok
        return self._fused_ok

    # -- scheduler protocol ------------------------------------------------
    def alloc(self, seq_id):
        for c in self.caches:
            c.alloc(seq_id)

    def free(self, seq_id):
        for c in self.caches:
            c.free(seq_id)

    def _check_tables(self, seq_id):
        tbl = self.caches[0].seq_pages(seq_id)
        if any(c.seq_pages(seq_id) != tbl for c in self.caches[1:]):
            raise AssertionError("the layers' KV page pools diverged")

    # -- prefix-cache hooks (inference/prefix_cache.py) --------------------
    def attach_prefix(self, seq_id, chains, length):
        """Cached prefill: register ``seq_id`` on shared page chains (one
        per layer) covering its first ``length`` tokens. The pages stay
        shared until the sequence's first write into the partial tail
        page, which the pool forks copy-on-write."""
        if len(chains) != len(self.caches):
            raise ValueError(
                f"{len(chains)} chains for {len(self.caches)} layers")
        for c, chain in zip(self.caches, chains):
            c.attach(seq_id, chain, length)
        self._check_tables(seq_id)

    def seq_page_chains(self, seq_id):
        """The sequence's physical page chain per layer: what the
        scheduler hands the radix tree at retire."""
        return [c.seq_pages(seq_id) for c in self.caches]

    # -- preemption hooks (HostKVSwapSpace) --------------------------------
    def swap_out(self, seq_id, space):
        """Page the sequence out of EVERY layer pool into the shared host
        swap space. Returns (pages_freed, nbytes_swapped) summed across
        layers."""
        freed = nbytes = 0
        for c in self.caches:
            fp, nb = c.swap_out(seq_id, space)
            freed += fp
            nbytes += nb
        return freed, nbytes

    def swap_in(self, seq_id, space):
        """Restore a swapped-out sequence into every layer pool (bit for
        bit). Returns the pages restored from the host."""
        restored = sum(c.swap_in(seq_id, space) for c in self.caches)
        self._check_tables(seq_id)
        return restored

    def _check_positions(self, seq_ids, lens, counts):
        # torch indexing faults on an out-of-range RoPE position (the
        # reference's jnp.take would clamp it, silently rotating with the
        # wrong phase): fail loudly on the host instead
        over = [s for s, n, c in zip(seq_ids, lens, counts)
                if n + c > self.max_length]
        if over:
            raise ValueError(
                f"sequences {over} would exceed max_length="
                f"{self.max_length}; positions beyond it cannot be "
                "rotary-encoded")

    def _book_step(self, seq_ids, counts, rows_pad=None, max_pages=None,
                   groups=None, op="append_ragged"):
        """Book one step's new tokens in every layer's pool, then build
        the step's device inputs ONCE for all layers (per row group with
        ``groups``, :meth:`PagedKVCacheManager.ragged_step_inputs`).
        Every pool goes through the same alloc/attach/append/free and
        swap calls, so their page tables agree; the pages each draws
        (copy-on-write fork destinations included) are checked to be the
        same. ``op`` names the bookings in a sanitized pool's journal."""
        drawn = self.caches[0].book_ragged(seq_ids, counts, op=op)
        for c in self.caches[1:]:
            if c.book_ragged(seq_ids, counts, op=op) != drawn:
                raise AssertionError("the layers' KV page pools diverged")
        return self.caches[0].ragged_step_inputs(
            seq_ids, counts, rows_pad=rows_pad, max_pages=max_pages,
            groups=groups)

    @torch.inference_mode()
    def decode_token(self, token_ids, seq_ids):
        """One token per listed sequence; returns logits (B, vocab)."""
        ragged_attention_mode()
        cfg = self.cfg
        b = len(seq_ids)
        nh, nkv, hd = (cfg.num_attention_heads, cfg.num_key_value_heads,
                       cfg.head_dim)
        lens = [self.caches[0].seq_len(s) for s in seq_ids]
        self._check_positions(seq_ids, lens, [1] * b)
        ids, pos = copy_to_device(
            [token_ids, np.asarray(lens)[:, None]], self.device,
            torch.int64)
        step = self._book_step(seq_ids, [1] * b, op="append_batch")
        x = self.model.model.embed_tokens(ids)              # (B, E)
        for li, layer in enumerate(self.model.model.layers):
            att = layer.self_attn
            xi = layer.input_layernorm(x)
            qh = att.q_proj(xi).reshape(b, 1, nh, hd)
            kh = att.k_proj(xi).reshape(b, 1, nkv, hd)
            vh = att.v_proj(xi).reshape(b, 1, nkv, hd)
            qh = apply_rotary_emb(qh, self._cos, self._sin, position_ids=pos)
            kh = apply_rotary_emb(kh, self._cos, self._sin, position_ids=pos)
            cache = self.caches[li]
            cache.append_ragged(seq_ids, [1] * b, kh[:, 0], vh[:, 0],
                                step=step)
            attn = cache.attend(qh[:, 0], seq_ids, window=self._window,
                                step=step)
            x = x + att.o_proj(attn.reshape(b, nh * hd))
            x = x + layer.mlp(layer.post_attention_layernorm(x))
        return self.model._head(self.model.model.norm(x))

    @torch.inference_mode()
    def prefill_chunk(self, token_ids, seq_ids, start_positions=None,
                      pad_to=None, logits_rows=None):
        """One ragged mixed prefill/decode step: row i appends the
        ``len(token_ids[i])`` tokens of ``token_ids[i]`` to sequence
        ``seq_ids[i]``, and the call returns the logits of every row's
        LAST token, (B, vocab). Single-token rows are decode rows,
        multi-token rows prefill chunks resuming at
        ``start_positions[i]`` (checked against the cache).

        ``logits_rows``: row indices whose per-position logits the caller
        also needs; the return value is then ``(last_logits,
        full_logits)``, ``full_logits`` the (sum of their counts, vocab)
        concatenation of the listed rows' positions in list order.

        The dense compute runs over ONE flat packed token axis padded to
        ``pad_to`` (the scheduler buckets it). Attention is one ragged
        kernel call per layer for the whole mixed batch, rows
        right-aligned, padded to power-of-two row/length/page-table
        shapes. Under ``FLAGS_ragged_attention=auto`` the layer step is
        the fused one (qkv + RoPE + page writes, the kernel, o_proj)
        where the pool is float; ``on`` runs the same kernel unfused;
        ``off`` routes decode rows through the decode kernel and prefill
        rows through the ragged kernel, two calls per layer
        (:meth:`_attend_rows_two_kernel`)."""
        mode = ragged_attention_mode()
        cfg = self.cfg
        b = len(seq_ids)
        counts = [len(t) for t in token_ids]
        if b != len(counts) or b == 0:
            raise ValueError(f"prefill_chunk: {len(counts)} token rows for "
                             f"{b} sequences")
        if min(counts) < 1:
            raise ValueError("prefill_chunk: every row must carry at least "
                             f"one token (counts={counts})")
        nh, nkv, hd = (cfg.num_attention_heads, cfg.num_key_value_heads,
                       cfg.head_dim)
        lens0 = [self.caches[0].seq_len(s) for s in seq_ids]
        if start_positions is not None:
            sp = [int(p) for p in start_positions]
            if sp != lens0:
                raise ValueError(
                    f"prefill_chunk: start_positions {sp} disagree with "
                    f"the cached lengths {lens0} — a chunk must resume "
                    "exactly where the cache left off")
        self._check_positions(seq_ids, lens0, counts)

        flat = np.concatenate([np.asarray(t, np.int64) for t in token_ids])
        n_real = int(flat.shape[0])
        pad_to = int(pad_to) if pad_to else n_real
        if pad_to < n_real:
            raise ValueError(f"prefill_chunk: pad_to={pad_to} below the "
                             f"packed token count {n_real}")
        flat = np.concatenate([flat, np.zeros(pad_to - n_real, np.int64)])
        pos_np = np.zeros(pad_to, np.int64)
        starts = np.zeros(b, np.int64)
        off = 0
        for i, (n, c) in enumerate(zip(lens0, counts)):
            starts[i] = off
            pos_np[off:off + c] = np.arange(n, n + c)
            off += c
        last_idx = starts + np.asarray(counts) - 1

        self._dispatch_shapes.add(pad_to)
        self.chunk_stats["calls"] += 1
        self.chunk_stats["packed_tokens"] += n_real
        self.chunk_stats["padded_tokens"] += pad_to - n_real

        page_size = self.caches[0].page_size
        mp_pad = _pow2(max(-(-(n + c) // page_size)
                           for n, c in zip(lens0, counts)))
        # the step's plans go over in one copy, its pool inputs in one
        # more, and every layer reuses them
        host = [flat, pos_np, last_idx]
        if logits_rows is not None:
            host.append(_packed_position_index(starts, counts, logits_rows))
        fuse = False
        if mode != "off":
            # ONE right-aligned ragged block for EVERY row: decode rows
            # are q_lens=1 rows of the same kernel call
            t_pad = _pow2(max(counts))
            b_pad = _pow2(b)
            gm, mr, mc, m_flat = _right_align_plan(
                range(b), starts, counts, t_pad, b_pad)
            fuse = mode == "auto" and self._fusion_eligible()
            self._note_program(pad_to, ("ragged_fused", b_pad, t_pad,
                                        mp_pad, pad_to) if fuse else
                               ("ragged", b_pad, t_pad, mp_pad))
            host += [gm, np.stack([mr, mc, m_flat])]
            groups = [(range(b), b_pad)]
        else:
            # the historical routing: single-token rows through the
            # decode kernel, multi-token rows right-aligned through the
            # ragged kernel
            singles = [i for i, c in enumerate(counts) if c == 1]
            multis = [i for i, c in enumerate(counts) if c > 1]
            groups = []
            if singles:
                bs_pad = _pow2(len(singles))
                self._note_program(pad_to, ("decode", bs_pad, 1, mp_pad))
                host.append(np.concatenate([
                    last_idx[singles],
                    np.zeros(bs_pad - len(singles), np.int64)]))
                groups.append((singles, bs_pad))
            if multis:
                t_pad = _pow2(max(counts[i] for i in multis))
                bm_pad = _pow2(len(multis))
                gm, mr, mc, m_flat = _right_align_plan(
                    multis, starts, counts, t_pad, bm_pad)
                self._note_program(pad_to, ("prefill", bm_pad, t_pad,
                                            mp_pad))
                host += [gm, np.stack([mr, mc, m_flat])]
                groups.append((multis, bm_pad))
        ids, pos, last_d, *rest = copy_to_device(host, self.device,
                                                 torch.int64)
        vidx = rest.pop(0) if logits_rows is not None else None
        steps = self._book_step(seq_ids, counts, max_pages=mp_pad,
                                groups=groups)
        step = steps[0]  # its write plan covers every row
        if mode != "off":
            gm_d, sc = rest
        else:
            # (kind, device plan, sequences, q_lens, kernel inputs)
            plans = []
            for (rows, _), st in zip(groups, steps):
                seqs = [seq_ids[i] for i in rows]
                if counts[rows[0]] == 1:
                    plans.append(("decode", rest.pop(0), seqs, None, st))
                else:
                    plans.append(("prefill", (rest.pop(0), rest.pop(0)),
                                  seqs, [counts[i] for i in rows], st))

        x = self.model.model.embed_tokens(ids)              # (N, E)
        for li, layer in enumerate(self.model.model.layers):
            cache = self.caches[li]
            att = layer.self_attn
            xi = layer.input_layernorm(x)
            if fuse:
                self.chunk_stats["attend_calls"] += 1
                biases = None
                if att.q_proj.bias is not None:
                    biases = (att.q_proj.bias, att.k_proj.bias,
                              att.v_proj.bias)
                y = cache.fused_ragged_step(
                    xi, (att.q_proj.weight, att.k_proj.weight,
                         att.v_proj.weight, att.o_proj.weight, biases),
                    (self._cos, self._sin), pos, seq_ids, counts, gm_d,
                    tuple(sc), rows_pad=b_pad, max_pages=mp_pad,
                    window=self._window, step=step)
                x = x + y
            else:
                qh = att.q_proj(xi).reshape(1, pad_to, nh, hd)
                kh = att.k_proj(xi).reshape(1, pad_to, nkv, hd)
                vh = att.v_proj(xi).reshape(pad_to, nkv, hd)
                qh = apply_rotary_emb(qh, self._cos, self._sin,
                                      position_ids=pos)[0]
                kh = apply_rotary_emb(kh, self._cos, self._sin,
                                      position_ids=pos)[0]
                cache.append_ragged(seq_ids, counts, kh[:n_real],
                                    vh[:n_real], step=step)
                attn = torch.zeros((pad_to, nh, hd), dtype=qh.dtype,
                                   device=self.device)
                if mode != "off":
                    self.chunk_stats["attend_calls"] += 1
                    out = cache.attend_ragged(
                        qh[gm_d], seq_ids, counts, window=self._window,
                        step=step)
                    attn[sc[2]] = out[sc[0], sc[1]]
                else:
                    self._attend_rows_two_kernel(cache, qh, attn, plans)
                x = x + att.o_proj(attn.reshape(pad_to, nh * hd))
            x = x + layer.mlp(layer.post_attention_layernorm(x))
        last = self.model._head(self.model.model.norm(x[last_d]))
        if logits_rows is None:
            return last
        full = self.model._head(self.model.model.norm(x[vidx]))
        return last, full

    @torch.inference_mode()
    def decode_window(self, token_windows, seq_ids):
        """Verify a w-token window per sequence in ONE forward pass (the
        legacy speculative verify): appends all w tokens of
        ``token_windows`` (B, w) to the pools (a rejection rolls back with
        ``cache.truncate``) and returns logits (B, w, vocab), ``[:, j]``
        conditioned on everything through window token j.

        The w queries attend over each sequence's pages gathered densely
        (:meth:`PagedKVCacheManager.dense_kv`, int8 pages dequantized)
        through one float32 masked attention, causal and, with a sliding
        window, windowed: plain torch, as the reference's is XLA."""
        cfg = self.cfg
        toks = np.asarray(token_windows, np.int64)
        b, w = toks.shape
        nh, nkv, hd = (cfg.num_attention_heads, cfg.num_key_value_heads,
                       cfg.head_dim)
        group = nh // nkv
        lens0 = [self.caches[0].seq_len(s) for s in seq_ids]
        over = [s for s, n in zip(seq_ids, lens0) if n + w > self.max_length]
        if over:
            raise ValueError(
                f"sequences {over} would exceed max_length="
                f"{self.max_length} verifying a {w}-token window")
        ids, pos = copy_to_device(
            [toks, np.asarray(lens0)[:, None] + np.arange(w)[None, :]],
            self.device, torch.int64)                      # (B, w) each
        x = self.model.model.embed_tokens(ids)             # (B, w, E)
        for li, layer in enumerate(self.model.model.layers):
            att = layer.self_attn
            xi = layer.input_layernorm(x)
            qh = att.q_proj(xi).reshape(b, w, nh, hd)
            kh = att.k_proj(xi).reshape(b, w, nkv, hd)
            vh = att.v_proj(xi).reshape(b, w, nkv, hd)
            qh = apply_rotary_emb(qh, self._cos, self._sin, position_ids=pos)
            kh = apply_rotary_emb(kh, self._cos, self._sin, position_ids=pos)
            c = self.caches[li]
            for j in range(w):
                c.append_batch(seq_ids, kh[:, j], vh[:, j])
            tbl, kd, vd = c.dense_kv(seq_ids)      # (B, MP, P, KVH, D)
            n_keys = tbl.shape[1] * c.page_size
            kd = kd.reshape(b, n_keys, nkv, hd).float()
            vd = vd.reshape(b, n_keys, nkv, hd).float()
            if group > 1:
                kd = kd.repeat_interleave(group, dim=2)
                vd = vd.repeat_interleave(group, dim=2)
            s = torch.einsum("bwhd,bkhd->bhwk", qh.float(), kd) \
                / math.sqrt(hd)
            kpos = torch.arange(n_keys, device=self.device)
            qpos = pos[:, None, :, None]
            ok = kpos <= qpos                          # causal in the window
            if self._window:
                ok = ok & (kpos > qpos - self._window)
            p = torch.softmax(s.masked_fill(~ok, -1e30), dim=-1)
            attn = torch.einsum("bhwk,bkhd->bwhd", p, vd)
            x = x + att.o_proj(attn.to(x.dtype).reshape(b, w, nh * hd))
            x = x + layer.mlp(layer.post_attention_layernorm(x))
        return self.model._head(self.model.model.norm(x))   # (B, w, V)

    def _attend_rows_two_kernel(self, cache, qh, attn, plans):
        """``FLAGS_ragged_attention=off``: decode rows through the decode
        kernel (:meth:`PagedKVCacheManager.attend_padded`), prefill rows
        right-aligned through the ragged kernel
        (:meth:`PagedKVCacheManager.attend_prefill`), each written into
        ``attn`` (pad_to, H, D) at its packed rows."""
        for kind, idx, seqs, q_lens, step in plans:
            self.chunk_stats["attend_calls"] += 1
            if kind == "decode":
                out = cache.attend_padded(qh[idx], seqs,
                                          window=self._window, step=step)
                attn[idx[:len(seqs)]] = out[:len(seqs)]
            else:
                gm, sc = idx
                out = cache.attend_prefill(qh[gm], seqs, q_lens,
                                           window=self._window, step=step)
                attn[sc[2]] = out[sc[0], sc[1]]
