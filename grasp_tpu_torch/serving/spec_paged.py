"""Speculative decoding over the paged continuous-batching engine
(counterpart of grasp_tpu/serving/spec_paged.py).

Combines :class:`~grasp_tpu_torch.serving.paged.ServingEngine`'s paged KV and
continuous batching with draft/verify speculation: the target model advances
up to gamma + 1 tokens per forward instead of 1.

- One page allocator: the draft and the target have page pools of their own
  (their layer counts may differ), sized alike, and a request's page table
  indexes both, so pages are allocated and freed once per request.
- Per macro-step every live row drafts gamma tokens (gamma + 1 batched
  one-token paged decodes on the draft pool, the body of
  ``paged._paged_decode_fn``), then the target verifies all rows in one
  batched (gamma + 1)-token paged forward (:func:`_paged_verify_fn`), whose
  attention is the chunk kernel of :mod:`grasp_tpu_torch.ops.paged_attention`.
- Greedy rows accept the longest prefix on which the target's argmax equals
  the draft, then take the target's correction: the stream the plain engine
  emits. On CUDA that rests on the chunk kernel being bit-equal, row by row,
  to the decode kernel; the projections around it are library products whose
  bits may depend on the number of rows, so on the card the identity is held
  to a bound and on the CPU in fp32 it is exact.
- Sampled rows draft from their own filtered distribution and take the
  rejection rule of ``speculative.speculative_accept`` row by row, so their
  stream is distributed exactly as target-only sampling at their settings.
  A request's draws all come from its one ``torch.Generator`` (gamma draft
  draws, gamma uniforms and one token per macro-step), so a stream is a
  function of its seed; it differs from the plain engine's stream for that
  seed, and from the JAX package's, in its bits.
- Rejected positions leave stale KV in both pools; the per-row masks hide
  them and the next chunk overwrites them in place.
- Penalties, logit bias, min_p and guided decoding: the draft adjusts each
  of its steps' logits with working copies of the rows' token counts and
  grammar states carried along its drafted tokens, and the acceptance
  recomputes the same adjustments position by position on the target's
  logits. Penalized greedy rows so emit the penalized plain engine's stream
  and penalized sampled rows follow penalized target-only sampling.
- The prefix cache: a page shared by content holds its first writer's
  target and draft K/V, so the draft's prefill also runs the suffix alone.
  Pages are allocated and freed through ``self.pool`` only; the draft pool
  never allocates.

Ported: fp and int8 pools, greedy and sampled rows in one batch, eos, every
sampling control of the plain engine and the prefix cache. ``logprobs`` and
``prefill_chunk`` raise ValueError (as in the JAX engine).
"""

from __future__ import annotations

import time
from typing import Dict, List, Optional

import numpy as np
import torch

from grasp_tpu_torch.configs import ModelConfig
from grasp_tpu_torch.eval.generate import topk_topp_filter
from grasp_tpu_torch.models.llama import (
    PROJ_ORDER,
    ModelPlan,
    Params,
    _quantize_kv,
    apply_rope,
    attention_scale,
    attn_mlp_residual,
    default_plan,
    embed_lookup,
    final_logits,
    norm,
    proj_apply,
    rope_cos_sin,
)
from grasp_tpu_torch.ops.paged_attention import paged_attention_chunk, paged_attention_gather
from grasp_tpu_torch.serving.paged import (
    _MAX_TOP_K,
    PagePool,
    ServingEngine,
    _paged_decode_fn,
    _full_layers,
    _Request,
    apply_penalties,
    mask_guided,
    paged_route,
    sampled_rows,
    sampling_settings,
)
from grasp_tpu_torch.serving.speculative import speculative_accept


def _paged_verify_fn(config: ModelConfig, plan: ModelPlan, chunk: int):
    """Build the batched multi-token paged forward (the verify step).

    (params, toks [B, chunk], k_pages, v_pages, tables [B, P] i32, pos [B],
    live [B], k_scales=None, v_scales=None) -> logits [B, chunk, V].
    pos[b] = cache slot of toks[b, 0]. Writes all ``chunk`` tokens' K/V into
    the pools in place, then query i of row b attends to slots <= pos + i.

    The attention mirrors the plain engine's decode, so that greedy
    speculation emits the stream the plain engine would: it takes
    ``paged_route``'s route for the call, the kernel route through
    ``paged_attention_chunk`` (on CUDA the chunk kernel, row by row bit-equal
    to the decode kernel; on CPU tensors its plain version), the gather route
    through ``paged_attention_gather`` in its chunk form with each layer's
    window and the softcap; int8 pools take the gather route, the chunk's
    K/V quantized per position exactly as the single-token scatter quantizes
    them. Dead rows (live=0) write on the null page 0 and attend from a base
    length of 1."""
    nh = config.num_attention_heads

    def fn(params, toks, k_pages, v_pages, tables, pos, live, k_scales=None, v_scales=None):
        L, nkv, _, page_size, hd = k_pages.shape
        b = toks.shape[0]
        positions = pos[:, None] + torch.arange(chunk, device=toks.device)[None, :]  # [B, C]
        cos, sin = rope_cos_sin(positions, hd, config.rope_theta, scaling=config.rope_scaling)
        h = embed_lookup(params, toks, config)  # [B, C, d]

        alive = live > 0
        logical = (positions // page_size).long()
        phys = tables.long().gather(1, logical)  # [B, C]
        # (row, i) pairs flattened row-major, as the values below are
        pf = torch.where(alive[:, None], phys, 0).reshape(-1)
        of = (positions % page_size).long().reshape(-1)
        base = torch.where(alive, pos + 1, 1).to(torch.int32)
        scale = attention_scale(config)
        route, _ = paged_route(config, tables.shape[1] * page_size, k_pages.dtype)

        for li in range(config.num_hidden_layers):
            lp = params["layers"][li]
            kinds = dict(zip(PROJ_ORDER, plan[li]))
            x = norm(h, lp["input_layernorm"]["weight"], config)
            ap = lp["self_attn"]
            q = proj_apply(x, ap["q_proj"], kinds["q_proj"]).reshape(b, chunk, nh, hd).transpose(1, 2)
            k = proj_apply(x, ap["k_proj"], kinds["k_proj"]).reshape(b, chunk, nkv, hd).transpose(1, 2)
            v = proj_apply(x, ap["v_proj"], kinds["v_proj"]).reshape(b, chunk, nkv, hd).transpose(1, 2)
            q, k = apply_rope(q, k, cos, sin)

            # torch applies the integer index first, so the [B * C] dim of
            # (pf, of) stays in place: the values are [nkv, B * C, hd]
            kw = k.permute(1, 0, 2, 3).reshape(nkv, b * chunk, hd)
            vw = v.permute(1, 0, 2, 3).reshape(nkv, b * chunk, hd)
            qc = q.transpose(1, 2).to(h.dtype).contiguous()  # [B, C, nh, hd]
            ks = vs = None
            if k_scales is not None:
                (k_pages[li][:, pf, of], k_scales[li][:, pf, of]) = _quantize_kv(kw)
                (v_pages[li][:, pf, of], v_scales[li][:, pf, of]) = _quantize_kv(vw)
                ks, vs = k_scales[li], v_scales[li]
            else:
                k_pages[li][:, pf, of] = kw.to(k_pages.dtype)
                v_pages[li][:, pf, of] = vw.to(v_pages.dtype)
            if route == "kernel":
                attn = paged_attention_chunk(qc, k_pages[li], v_pages[li], base, tables, scale)
            else:
                attn = paged_attention_gather(qc, k_pages[li], v_pages[li], base, tables, scale,
                                              window=config.layer_window(li),
                                              cap=config.attn_logit_softcapping,
                                              k_scales=ks, v_scales=vs)
            attn = proj_apply(attn.reshape(b, chunk, nh * hd), ap["o_proj"], kinds["o_proj"])
            h = attn_mlp_residual(h, attn, lp, kinds, config)

        return final_logits(h, params, config)

    return fn


class _Penalties:
    """A penalized macro-step's context on the device, rows in batch order:
    ``counts`` [B, V] int32 and ``bias`` [B, V] fp32 (zero where a row has
    no logit bias), per-row ``min_ps``, ``pres``, ``freq`` and ``reps``, and
    for guided batches a grammar table ``trans`` [S, V] (token transitions,
    -1 = reject), ``accept`` [S], the rows' ``states`` [B] and ``flags`` [B]
    and the stop ids' ``eos_mask`` [V]; ``trans`` is None when no row is
    guided."""

    __slots__ = ("counts", "bias", "min_ps", "pres", "freq", "reps", "trans", "accept",
                 "states", "flags", "eos_mask")

    def __init__(self, **kw):
        for name in self.__slots__:
            setattr(self, name, kw.get(name))

    def adjust(self, logits: torch.Tensor, counts: torch.Tensor, states: Optional[torch.Tensor],
               rep: int = 1) -> torch.Tensor:
        """The plain engine's penalized adjustments (and grammar mask) of
        [B * rep, V] logits, each row's settings repeated ``rep`` times."""
        def per_row(t):
            return t.repeat_interleave(rep, dim=0) if rep > 1 else t

        adj = apply_penalties(logits, counts, per_row(self.bias), per_row(self.pres),
                              per_row(self.freq), per_row(self.reps))
        if self.trans is None:
            return adj
        return mask_guided(adj, self.trans[states] >= 0, self.accept[states], self.eos_mask,
                           per_row(self.flags))

    def advance(self, states: torch.Tensor, toks: torch.Tensor) -> torch.Tensor:
        """The rows' grammar states after picking ``toks``: a stop id, a
        rejected token or an unguided row keeps its state."""
        ns = self.trans[states, toks].long()
        return torch.where(self.flags & ~self.eos_mask[toks] & (ns >= 0), ns, states)


def _draft_multi_fn(config: ModelConfig, plan: ModelPlan, gamma: int, max_k: int = _MAX_TOP_K):
    """Build the draft phase: gamma + 1 one-token paged decodes on the draft
    pool, each next token fed to the following step on the device, nothing
    synchronised with the host. Step gamma (the last) only lands d_gamma's
    KV; its logits are dropped.

    Greedy rows (and every row when ``reqs`` holds no sampling request) take
    the argmax of the raw logits. A sampled row draws its next draft token
    from its own filtered distribution (per-row temperature, top-k, top-p; one
    draw from the request's generator per step), and each step's filtered
    draft probabilities are kept for the acceptance step. With ``pen`` (a
    :class:`_Penalties`) each step's logits are adjusted first, with working
    copies of the counts and grammar states advanced by every drafted token,
    and the filter adds min_p.

    (params, tok0 [B], k_pages, v_pages, tables, pos0 [B], live [B],
    k_scales=None, v_scales=None, reqs=(), pen=None) -> (drafts [B, gamma],
    q_probs [B, gamma, V] fp32, or None for an all-greedy batch)."""
    body = _paged_decode_fn(config, plan)

    def fn(params, tok0, k_pages, v_pages, tables, pos0, live, k_scales=None, v_scales=None,
           reqs=(), pen=None):
        sampled = sampled_rows(reqs)
        if sampled:
            temps, ks, top_ps = sampling_settings(reqs, sampled, tok0.device)
        if pen is not None:
            counts, states = pen.counts.clone(), pen.states
            every_row = torch.arange(tok0.shape[0], device=tok0.device)
        tok, drafts, qs = tok0, [], []
        for i in range(gamma + 1):
            logits = body(params, tok, k_pages, v_pages, tables, pos0 + i, live,
                          k_scales, v_scales)
            if i == gamma:
                break
            scores = logits if pen is None else pen.adjust(logits, counts, states)
            tok = torch.argmax(scores, dim=-1)
            if sampled:
                filt = topk_topp_filter(scores.float() / temps[:, None], ks, top_ps, max_k,
                                        min_ps=None if pen is None else pen.min_ps)
                q_i = torch.softmax(filt, dim=-1)
                for row in sampled:
                    tok[row] = torch.multinomial(q_i[row], 1, generator=reqs[row].generator)[0]
                qs.append(q_i)
            if pen is not None:
                counts[every_row, tok] += 1
                if pen.trans is not None:
                    states = pen.advance(states, tok)
            drafts.append(tok)
        return torch.stack(drafts, dim=1), (torch.stack(qs, dim=1) if sampled else None)

    return fn


def _accept_fn(gamma: int, max_k: int):
    """Build the batched acceptance: greedy rows take the argmax-prefix rule,
    sampled rows the rejection rule of ``speculative_accept`` with their own
    generator. Everything stays on the device. With ``pen`` the target's
    logits at chunk position i are adjusted as the draft adjusted its own
    there: counts plus d_1 .. d_i, grammar states rolled through them.

    (tlogits [B, gamma + 1, V], drafts [B, gamma], q_probs [B, gamma, V] or
    None for an all-greedy batch, reqs, pen=None) -> (a [B] accepted counts,
    corr [B] correction or bonus token, targets [B, gamma + 1] the target's
    argmax)."""

    def fn(tlogits, drafts, q_probs, reqs, pen=None):
        b, g1, v = tlogits.shape
        scores = tlogits
        if pen is not None:
            drafted = torch.nn.functional.one_hot(drafts, v).to(torch.int32).cumsum(
                dim=1, dtype=torch.int32)
            counts = torch.cat([pen.counts[:, None], pen.counts[:, None] + drafted], dim=1)
            states = None
            if pen.trans is not None:
                states = [pen.states]
                for i in range(gamma):
                    states.append(pen.advance(states[-1], drafts[:, i]))
                states = torch.stack(states, dim=1).reshape(-1)
            scores = pen.adjust(tlogits.reshape(b * g1, v), counts.reshape(b * g1, v), states,
                                rep=g1).reshape(b, g1, v)
        targets = torch.argmax(scores, dim=-1)  # [B, gamma + 1]
        matches = torch.cumprod((targets[:, :gamma] == drafts).to(torch.int64), dim=1)
        a = matches.sum(dim=1)
        corr = targets.gather(1, a[:, None])[:, 0]
        if q_probs is None:
            return a, corr, targets
        sampled = sampled_rows(reqs)
        if sampled:
            temps, ks, top_ps = sampling_settings(reqs, sampled, tlogits.device)
            rows = torch.tensor(sampled, device=tlogits.device)
            scaled = scores[rows].float() / temps[rows, None, None]
            filt = topk_topp_filter(
                scaled.reshape(len(sampled) * g1, v), ks[rows].repeat_interleave(g1),
                top_ps[rows].repeat_interleave(g1), max_k,
                min_ps=None if pen is None else pen.min_ps[rows].repeat_interleave(g1))
            p_probs = torch.softmax(filt, dim=-1).reshape(len(sampled), g1, v)
            for n, row in enumerate(sampled):
                a[row], corr[row] = speculative_accept(reqs[row].generator, drafts[row],
                                                       q_probs[row], p_probs[n])
        return a, corr, targets

    return fn


class SpeculativeServingEngine(ServingEngine):
    """Continuous batching, paged KV and speculation, for greedy and sampled
    requests in one batch.

    Admission, retirement and page accounting are ServingEngine's; the target
    pool is ``self.pool`` and a draft pool rides the same page tables.
    ``step()`` advances every live row by up to gamma + 1 tokens.
    ``macro_steps`` counts those steps (each runs the verify forward once, so
    every layer's chunk-attention kernel once), ``decode_steps`` the draft's
    batched one-token decodes (gamma + 1 per macro-step, each running every
    draft layer's decode kernel once), ``decode_seconds`` the host time inside
    macro-steps. ``last_stats`` counts chunks (live rows x macro-steps),
    drafted and accepted tokens."""

    def __init__(self, params: Params, config: ModelConfig, draft_params: Params,
                 draft_config: ModelConfig, plan: Optional[ModelPlan] = None,
                 draft_plan: Optional[ModelPlan] = None, gamma: int = 4, **kw):
        if config.vocab_size != draft_config.vocab_size:
            raise ValueError("draft and target must share a vocabulary")
        if kw.get("prefill_chunk"):
            raise ValueError("prefill_chunk is not supported with speculation; "
                             "use ServingEngine")
        if gamma < 1:
            raise ValueError(f"gamma must be at least 1, got {gamma}")
        self.gamma = int(gamma)  # before super(): _pages_needed reads it
        super().__init__(params, config, plan=plan, **kw)
        self.dparams = draft_params
        self.dconfig = draft_config
        self.dplan = draft_plan or default_plan(draft_config)
        quantized = self.pool.quantized  # int8 pages and scales in both pools
        # a physical page backs both pools, so it recycles only once every
        # later query of target and draft is masked from it: both slide, in
        # every layer; the step never stalls, so allocation stays upfront
        self._window_recycle = None
        if not any(c.sliding_window is None or _full_layers(c) for c in (config, draft_config)):
            self._window_recycle = max(config.sliding_window, draft_config.sliding_window)
        self._lazy_pages = False
        self.draft_route = paged_route(draft_config, self.max_pages_per_seq * self.pool.page_size,
                                       self.pool.k_pages.dtype)
        # the tables index both pools; pages are allocated, shared and freed
        # through self.pool alone, the draft pool's own allocator stays unused
        self.dpool = PagePool(draft_config, self.pool.num_pages, self.pool.page_size,
                              device=self.device, quantized=quantized)
        self._gtables = None  # (grammar ids, trans, accept, state offsets) of a mixed batch
        self._dmulti = _draft_multi_fn(draft_config, self.dplan, self.gamma)
        self._verify = _paged_verify_fn(config, self.plan, self.gamma + 1)
        self._accept = _accept_fn(self.gamma, _MAX_TOP_K)
        self.macro_steps = 0
        self.last_stats: Dict[str, float] = {"chunks": 0, "drafted": 0, "accepted": 0}

    def submit(self, prompt_ids, max_new_tokens: int, temperature: float = 0.0,
               top_k: int = 0, top_p: float = 1.0, seed: Optional[int] = None,
               logprobs: int = 0, **sampling) -> int:
        """Enqueue a request. Greedy rows emit the plain engine's stream;
        sampled rows (temperature > 0) speculate through the rejection rule
        and follow the target's distribution exactly; the penalties, logit
        bias, min_p and guided_regex of :meth:`ServingEngine.submit` keep
        both. ``logprobs`` is refused: a macro-step emits accepted tokens in
        bulk, without a distribution per token. A request reserves gamma + 1
        slots beyond its last token: a macro-step may write that far past
        the accepted stream."""
        if logprobs:
            raise ValueError("logprobs are not supported with speculation; use ServingEngine")
        return super().submit(prompt_ids, max_new_tokens, temperature, top_k, top_p, seed,
                              **sampling)

    def _pages_needed(self, prompt_len: int, max_new: int) -> int:
        return -(-(prompt_len + max_new + self.gamma + 1) // self.pool.page_size)

    def _admit(self, req: _Request, row: int) -> None:
        """Admit into both pools: the target as the plain engine does (its
        cached prefix pages included), then the draft's prefill of the
        prompt's suffix into the same pages, after the draft K/V of the
        shared ones."""
        adm = self._admit_start(req, row)
        if not self._admit_chunk(adm):  # prefill_chunk is refused above
            raise AssertionError("a speculative admission prefills the whole prompt")
        self._prefill_into(self.dpool, self.dparams, self.dconfig, self.dplan, req,
                           adm.prefix_len)

    def _guided_tables(self, reqs: List[_Request]):
        """(trans [S, V] int32, accept [S] bool, states [max_batch],
        flags [max_batch]) on the device for the guided rows of ``reqs``. One
        grammar: its own table, uploaded once and cached on it; several: one
        block-diagonal table (states offset per grammar), cached until the
        set of grammars changes."""
        grammars = []
        for r in reqs:
            if r.guided is not None and all(g is not r.guided for g in grammars):
                grammars.append(r.guided)
        if len(grammars) == 1:
            g = grammars[0]
            cache = g.__dict__.setdefault("_dev_trans", {})
            if str(self.device) not in cache:
                cache[str(self.device)] = (torch.from_numpy(g.token_trans).to(self.device),
                                           torch.from_numpy(g.accepting).to(self.device))
            trans, accept = cache[str(self.device)]
            offsets = {id(g): 0}
        else:
            key = tuple(id(g) for g in grammars)
            if self._gtables is None or self._gtables[0] != key:
                n = sum(g.n_states for g in grammars)
                trans = np.full((n, self.config.vocab_size), -1, np.int32)
                accept = np.zeros(n, bool)
                offsets, off = {}, 0
                for g in grammars:
                    trans[off:off + g.n_states] = np.where(g.token_trans >= 0,
                                                           g.token_trans + off, -1)
                    accept[off:off + g.n_states] = g.accepting
                    offsets[id(g)] = off
                    off += g.n_states
                self._gtables = (key, torch.from_numpy(trans).to(self.device),
                                 torch.from_numpy(accept).to(self.device), offsets)
            _, trans, accept, offsets = self._gtables
        states = torch.zeros(self.max_batch, dtype=torch.long)
        flags = torch.zeros(self.max_batch, dtype=torch.bool)
        for r in reqs:
            if r.guided is not None:
                states[r.row], flags[r.row] = offsets[id(r.guided)] + r.gstate, True
        return trans, accept, states.to(self.device), flags.to(self.device)

    def _penalties(self, live_reqs: List[_Request]) -> _Penalties:
        """The macro-step's :class:`_Penalties` over the batch's rows."""
        min_ps, pres, freq, reps, biased = self._penalty_rows(list(self._live))
        pen = _Penalties(counts=self._counts, bias=self._bias * biased[:, None], min_ps=min_ps,
                         pres=pres, freq=freq, reps=reps)
        if any(r.guided is not None for r in live_reqs):
            pen.trans, pen.accept, pen.states, pen.flags = self._guided_tables(live_reqs)
            pen.eos_mask = self._eos_mask_dev()
        return pen

    def _commit_penalized(self, live_reqs: List[_Request], drafts, a_arr, corr) -> None:
        """Fold each row's picks of the macro-step (its accepted drafts and
        the correction or bonus token, counted at pick time as the plain
        engine counts) into the counts of penalized rows, and advance the
        guided rows' grammar states through them."""
        rows, toks = [], []
        for r in live_reqs:
            picks = drafts[r.row, :int(a_arr[r.row])].tolist() + [int(corr[r.row])]
            if r.penalized:
                rows += [r.row] * len(picks)
                toks += picks
            if r.guided is not None:
                self._advance_grammar(r, picks)
        if rows:
            self._counts.index_put_(
                (self._ids(rows), self._ids(toks)),
                torch.ones(len(rows), dtype=torch.int32, device=self.device), accumulate=True)

    def _emit_all(self, req: _Request, toks) -> None:
        """Emit ``toks`` in order until the request stops: at a stop token or
        at its max_new'th token it retires and the rest is dropped."""
        for tok in toks:
            if not self._emit(req, tok):
                return
            if len(req.out) >= req.max_new:
                self._retire(req)
                return

    # -- the speculative macro-step ---------------------------------------
    def step(self) -> None:
        self._admit_pending()

        # emit the token computed by the previous step or by prefill
        for r in list(self._live):
            if r is not None:
                self._emit_all(r, [int(self._next_tok[r.row])])

        tables, pos0, live = self._batch_state()
        if not live.any():
            return
        reqs = list(self._live)
        live_reqs = [r for r in reqs if r is not None]
        # the chunk writes slots pos .. pos + gamma; submit() reserved them
        capacity = self.max_pages_per_seq * self.pool.page_size
        if int(pos0.max()) + self.gamma + 1 > capacity:
            raise RuntimeError(f"a row at position {int(pos0.max())} plus a chunk of "
                               f"{self.gamma + 1} exceeds its page table's {capacity} slots")

        t0 = time.perf_counter()
        dev, gamma = self.device, self.gamma
        tok0 = torch.from_numpy(self._next_tok.astype(np.int64)).to(dev)
        state = (torch.from_numpy(tables).to(dev), torch.from_numpy(pos0).to(dev),
                 torch.from_numpy(live).to(dev))
        dpool, pool = self.dpool, self.pool
        pen = self._penalties(live_reqs) if any(r.penalized for r in live_reqs) else None
        drafts, q_probs = self._dmulti(self.dparams, tok0, dpool.k_pages, dpool.v_pages, *state,
                                       dpool.k_scales, dpool.v_scales, reqs, pen)
        # target verify: one batched (gamma + 1)-token paged forward
        verify_in = torch.cat([tok0[:, None], drafts], dim=1)
        tlogits = self._verify(self.params, verify_in, pool.k_pages, pool.v_pages, *state,
                               pool.k_scales, pool.v_scales)
        a_dev, corr_dev, _ = self._accept(tlogits, drafts, q_probs, reqs, pen)
        # the macro-step's one synchronisation with the host
        block = torch.cat([drafts, a_dev[:, None], corr_dev[:, None]], dim=1).cpu().numpy()
        drafts_h, a_arr, corr = block[:, :gamma], block[:, gamma], block[:, gamma + 1]
        self.decode_seconds += time.perf_counter() - t0
        self.decode_steps += gamma + 1
        self.macro_steps += 1
        if pen is not None:
            self._commit_penalized(live_reqs, drafts_h, a_arr, corr)

        # emission per row (host bookkeeping)
        self.last_stats["chunks"] += len(live_reqs)
        self.last_stats["drafted"] += len(live_reqs) * gamma
        for r in live_reqs:
            row = r.row
            a = int(a_arr[row])
            self.last_stats["accepted"] += a
            # d_1..d_a are emitted now; the correction or bonus token becomes
            # the pending token, emitted at the top of the next step.
            # verify_in[0] was emitted at the top of this one.
            r.pos += a + 1
            self._recycle_window_pages(r)
            self._next_tok[row] = int(corr[row])
            self._emit_all(r, drafts_h[row, :a].tolist())

    @property
    def acceptance_rate(self) -> float:
        return self.last_stats["accepted"] / max(self.last_stats["drafted"], 1)
