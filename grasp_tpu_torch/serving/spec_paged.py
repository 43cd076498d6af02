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

Ported: fp and int8 pools, greedy and sampled rows in one batch, eos.
``logprobs`` and ``prefill_chunk`` raise ValueError (as in the JAX engine);
penalties, logit bias, guided decoding and the prefix cache raise
NotImplementedError, as in the plain engine of this package.
"""

from __future__ import annotations

import time
from typing import Dict, Optional

import numpy as np
import torch

from grasp_tpu_torch.configs import ModelConfig
from grasp_tpu_torch.eval.generate import topk_topp_filter
from grasp_tpu_torch.models.llama import (
    PROJ_ORDER,
    ModelPlan,
    Params,
    _lm_logits,
    _quantize_kv,
    apply_rope,
    attention_scale,
    attn_mlp_residual,
    default_plan,
    embed_lookup,
    proj_apply,
    rms_norm,
    rope_cos_sin,
)
from grasp_tpu_torch.ops.paged_attention import (
    check_kernel_shape,
    paged_attention_chunk,
    paged_attention_q8_gather,
)
from grasp_tpu_torch.serving.paged import (
    _MAX_TOP_K,
    PagePool,
    ServingEngine,
    _paged_decode_fn,
    _Request,
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
    speculation emits the stream the plain engine would: fp pools go through
    ``paged_attention_chunk`` (on CUDA the chunk kernel, row by row bit-equal
    to the decode kernel; on CPU tensors its plain version), int8 pools
    through the decode's gather route, the chunk's K/V quantized per position
    exactly as the single-token scatter quantizes them. Dead rows (live=0)
    write on the null page 0 and attend from a base length of 1."""
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

        for li in range(config.num_hidden_layers):
            lp = params["layers"][li]
            kinds = dict(zip(PROJ_ORDER, plan[li]))
            x = rms_norm(h, lp["input_layernorm"]["weight"], config.rms_norm_eps)
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
            if k_scales is not None:
                (k_pages[li][:, pf, of], k_scales[li][:, pf, of]) = _quantize_kv(kw)
                (v_pages[li][:, pf, of], v_scales[li][:, pf, of]) = _quantize_kv(vw)
                attn = paged_attention_q8_gather(qc, k_pages[li], v_pages[li], k_scales[li],
                                                 v_scales[li], base, tables, scale)
            else:
                k_pages[li][:, pf, of] = kw.to(k_pages.dtype)
                v_pages[li][:, pf, of] = vw.to(v_pages.dtype)
                attn = paged_attention_chunk(qc, k_pages[li], v_pages[li], base, tables, scale)
            attn = proj_apply(attn.reshape(b, chunk, nh * hd), ap["o_proj"], kinds["o_proj"])
            h = attn_mlp_residual(h, attn, lp, kinds, config)

        h = rms_norm(h, params["norm"]["weight"], config.rms_norm_eps)
        return _lm_logits(h, params)

    return fn


def _draft_multi_fn(config: ModelConfig, plan: ModelPlan, gamma: int, max_k: int = _MAX_TOP_K):
    """Build the draft phase: gamma + 1 one-token paged decodes on the draft
    pool, each next token fed to the following step on the device, nothing
    synchronised with the host. Step gamma (the last) only lands d_gamma's
    KV; its logits are dropped.

    Greedy rows (and every row when ``reqs`` holds no sampling request) take
    the argmax of the raw logits. A sampled row draws its next draft token
    from its own filtered distribution (per-row temperature, top-k, top-p; one
    draw from the request's generator per step), and each step's filtered
    draft probabilities are kept for the acceptance step.

    (params, tok0 [B], k_pages, v_pages, tables, pos0 [B], live [B],
    k_scales=None, v_scales=None, reqs=()) -> (drafts [B, gamma], q_probs
    [B, gamma, V] fp32, or None for an all-greedy batch)."""
    body = _paged_decode_fn(config, plan)

    def fn(params, tok0, k_pages, v_pages, tables, pos0, live, k_scales=None, v_scales=None,
           reqs=()):
        sampled = sampled_rows(reqs)
        if sampled:
            temps, ks, top_ps = sampling_settings(reqs, sampled, tok0.device)
        tok, drafts, qs = tok0, [], []
        for i in range(gamma + 1):
            logits = body(params, tok, k_pages, v_pages, tables, pos0 + i, live,
                          k_scales, v_scales)
            if i == gamma:
                break
            tok = torch.argmax(logits, dim=-1)
            if sampled:
                filt = topk_topp_filter(logits.float() / temps[:, None], ks, top_ps, max_k)
                q_i = torch.softmax(filt, dim=-1)
                for row in sampled:
                    tok[row] = torch.multinomial(q_i[row], 1, generator=reqs[row].generator)[0]
                qs.append(q_i)
            drafts.append(tok)
        return torch.stack(drafts, dim=1), (torch.stack(qs, dim=1) if sampled else None)

    return fn


def _accept_fn(gamma: int, max_k: int):
    """Build the batched acceptance: greedy rows take the argmax-prefix rule,
    sampled rows the rejection rule of ``speculative_accept`` with their own
    generator. Everything stays on the device.

    (tlogits [B, gamma + 1, V], drafts [B, gamma], q_probs [B, gamma, V] or
    None for an all-greedy batch, reqs) -> (a [B] accepted counts, corr [B]
    correction or bonus token, targets [B, gamma + 1] the target's argmax)."""

    def fn(tlogits, drafts, q_probs, reqs):
        b, g1, v = tlogits.shape
        targets = torch.argmax(tlogits, dim=-1)  # [B, gamma + 1]
        matches = torch.cumprod((targets[:, :gamma] == drafts).to(torch.int64), dim=1)
        a = matches.sum(dim=1)
        corr = targets.gather(1, a[:, None])[:, 0]
        if q_probs is None:
            return a, corr, targets
        sampled = sampled_rows(reqs)
        if sampled:
            temps, ks, top_ps = sampling_settings(reqs, sampled, tlogits.device)
            rows = torch.tensor(sampled, device=tlogits.device)
            scaled = tlogits[rows].float() / temps[rows, None, None]
            filt = topk_topp_filter(scaled.reshape(len(sampled) * g1, v),
                                    ks[rows].repeat_interleave(g1),
                                    top_ps[rows].repeat_interleave(g1), max_k)
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
        if self.device.type == "cuda" and not quantized:
            check_kernel_shape(draft_config.num_attention_heads,
                               draft_config.num_key_value_heads, draft_config.head_dim_)
        self.dpool = PagePool(draft_config, self.pool.num_pages, self.pool.page_size,
                              device=self.device, quantized=quantized)
        self.dpool._free = self.pool._free  # one allocator: the tables index both pools
        self._dmulti = _draft_multi_fn(draft_config, self.dplan, self.gamma)
        self._verify = _paged_verify_fn(config, self.plan, self.gamma + 1)
        self._accept = _accept_fn(self.gamma, _MAX_TOP_K)
        self.macro_steps = 0
        self.last_stats: Dict[str, float] = {"chunks": 0, "drafted": 0, "accepted": 0}

    def submit(self, prompt_ids, max_new_tokens: int, temperature: float = 0.0,
               top_k: int = 0, top_p: float = 1.0, seed: Optional[int] = None,
               logprobs: int = 0, **unsupported) -> int:
        """Enqueue a request. Greedy rows emit the plain engine's stream;
        sampled rows (temperature > 0) speculate through the rejection rule
        and follow the target's distribution exactly. ``logprobs`` is refused:
        a macro-step emits accepted tokens in bulk, without a distribution per
        token. A request reserves gamma + 1 slots beyond its last token: a
        macro-step may write that far past the accepted stream."""
        if logprobs:
            raise ValueError("logprobs are not supported with speculation; use ServingEngine")
        return super().submit(prompt_ids, max_new_tokens, temperature, top_k, top_p, seed,
                              **unsupported)

    def _pages_needed(self, prompt_len: int, max_new: int) -> int:
        return -(-(prompt_len + max_new + self.gamma + 1) // self.pool.page_size)

    def _admit(self, req: _Request, row: int) -> None:
        """Admit into both pools: the target as the plain engine does, then
        the draft's prefill of the same prompt into the same pages."""
        super()._admit(req, row)
        self._prefill_into(self.dpool, self.dparams, self.dconfig, self.dplan, req)

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
        drafts, q_probs = self._dmulti(self.dparams, tok0, dpool.k_pages, dpool.v_pages, *state,
                                       dpool.k_scales, dpool.v_scales, reqs)
        # target verify: one batched (gamma + 1)-token paged forward
        verify_in = torch.cat([tok0[:, None], drafts], dim=1)
        tlogits = self._verify(self.params, verify_in, pool.k_pages, pool.v_pages, *state,
                               pool.k_scales, pool.v_scales)
        a_dev, corr_dev, _ = self._accept(tlogits, drafts, q_probs, reqs)
        # the macro-step's one synchronisation with the host
        block = torch.cat([drafts, a_dev[:, None], corr_dev[:, None]], dim=1).cpu().numpy()
        drafts_h, a_arr, corr = block[:, :gamma], block[:, gamma], block[:, gamma + 1]
        self.decode_seconds += time.perf_counter() - t0
        self.decode_steps += gamma + 1
        self.macro_steps += 1

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
            self._next_tok[row] = int(corr[row])
            self._emit_all(r, drafts_h[row, :a].tolist())

    @property
    def acceptance_rate(self) -> float:
        return self.last_stats["accepted"] / max(self.last_stats["drafted"], 1)
