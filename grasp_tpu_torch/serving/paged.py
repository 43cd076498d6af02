"""Paged KV cache + continuous batching (counterpart of grasp_tpu/serving/paged.py).

KV lives in a global page pool per layer, ``k_pages/v_pages: [L, nkv,
num_pages, page_size, hd]``; each sequence owns a page table (logical block ->
physical page), and a refcounted free list recycles pages the moment a
request finishes. :class:`ServingEngine` batches continuously: requests join
mid-flight (prefill into fresh pages), finished rows retire and free their
pages, and every decode step advances all live rows at once.

Decode attention takes one of two routes, chosen by :func:`paged_route`
from the config, the table's capacity and the pool's dtype, as the JAX engine
chooses: the CUDA kernel of :mod:`grasp_tpu_torch.ops.paged_attention` (its
plain version on CPU tensors), which reads the pages in place through the
page table, or the gather route (``paged_attention_gather``) for what the
kernel does not compute: int8 pools (``quantized_kv``: int8 pages with one
fp32 scale per page slot and head), an attention softcap (Gemma-2), a
sliding window shorter than the table (Mistral, Gemma-2), a head layout the
kernel lacks (head_dim 256: Gemma). The pools are updated in place; the JAX
engine donated them to its jitted step instead.

- Sliding windows: each layer attends under its own window. When every layer
  slides, a row's pages that every later query is masked from return to the
  pool as it decodes (its table entry becomes the null page), generation pages
  are allocated as the write position enters them, admission reserves each
  row's peak (its prompt pages and a band of window / page_size + 2), and a
  row whose next page the pool cannot give stalls (no emit, no decode, no
  draw from its generator) until one frees: the rolling-buffer cache.

- ``prefix_cache``: full prompt pages are content-hashed (a chained blake2b
  over the int32 token bytes) and shared between requests, refcounted; a hit
  gathers the cached K/V into the prefill's temporary cache and only the
  prompt's suffix runs the model. Zero-ref registered pages park in an LRU
  and are reclaimed by ``alloc`` when the free list is empty.
- ``prefill_chunk``: admission runs the prompt ``prefill_chunk`` tokens per
  ``step()`` while the live rows go on decoding.
- Sampling: greedy, temperature / top-k / top-p with one ``torch.Generator``
  per request, and the penalized pick (logit bias, repetition, presence and
  frequency penalties, min_p) over per-row token counts and bias rows kept on
  the engine's device; guided decoding masks each pick to the tokens a
  grammar DFA (:mod:`grasp_tpu_torch.serving.guided`) can consume.
"""

from __future__ import annotations

import functools
import hashlib
import time
from collections import OrderedDict
from typing import Dict, List, Optional

import numpy as np
import torch

from grasp_tpu_torch.configs import ModelConfig
from grasp_tpu_torch.eval.generate import topk_topp_filter
from grasp_tpu_torch.models.llama import (
    PROJ_ORDER,
    ModelPlan,
    Params,
    _forward_with_cache,
    _quantize_kv,
    apply_rope,
    attention_scale,
    attn_mlp_residual,
    default_plan,
    embed_lookup,
    final_logits,
    init_kv_cache,
    norm,
    proj_apply,
    rope_cos_sin,
    torch_dtype,
)
from grasp_tpu_torch.ops.paged_attention import (
    kernel_shape_error,
    paged_attention,
    paged_attention_gather,
)
from grasp_tpu_torch.serving.guided import CompiledGrammar, token_bytes_of


class PagePool:
    """Global KV page pool (device) + host-side refcounting allocator.
    Page 0 is the reserved null page that unallocated table slots and dead
    rows point at. ``quantized``: int8 pages with fp32 absmax scales per
    (page slot, head), ``k_scales``/``v_scales`` [L, nkv, P, ps, 1] (the int8
    KV scheme of models/llama.py); otherwise both are None.

    The prefix cache shares one physical page between requests whose prompts
    agree on its content: ``lookup_shared`` takes a reference, ``free``
    releases one, and a zero-ref page registered under a content hash parks
    in an LRU of evictable pages instead of the free list. ``alloc`` takes
    the free list first, then reclaims the least recently shared page; the
    order is the JAX allocator's, step for step."""

    def __init__(self, config: ModelConfig, num_pages: int, page_size: int = 128, *,
                 device, dtype: Optional[torch.dtype] = None, quantized: bool = False):
        self.config = config
        self.num_pages = num_pages
        self.page_size = page_size
        self.quantized = quantized
        dtype = torch.int8 if quantized else (dtype or torch_dtype(config.dtype))
        # [L, nkv, P, ps, hd]: each layer's slice is the kernel's
        # [num_kv_heads, total_pages, page_size, head_dim]
        shape = (config.num_hidden_layers, config.num_key_value_heads, num_pages,
                 page_size, config.head_dim_)
        self.k_pages = torch.zeros(shape, dtype=dtype, device=device)
        self.v_pages = torch.zeros(shape, dtype=dtype, device=device)
        self.k_scales = self.v_scales = None
        if quantized:
            self.k_scales = torch.ones(shape[:-1] + (1,), dtype=torch.float32, device=device)
            self.v_scales = torch.ones(shape[:-1] + (1,), dtype=torch.float32, device=device)
        self._free: List[int] = list(range(num_pages - 1, 0, -1))
        self._ref = [0] * num_pages
        # content hash <-> page of the prefix cache; zero-ref registered pages
        # wait in _evictable (least recently shared first)
        self._hash_to_page: Dict[bytes, int] = {}
        self._page_to_hash: Dict[int, bytes] = {}
        self._evictable: "OrderedDict[int, None]" = OrderedDict()

    def alloc(self, n: int) -> List[int]:
        if n > self.free_pages:
            raise MemoryError(f"page pool exhausted: need {n}, have {self.free_pages} free")
        out = []
        for _ in range(n):
            if self._free:
                p = self._free.pop()
            else:  # reclaim the least recently shared cached page
                p, _ = self._evictable.popitem(last=False)
                del self._hash_to_page[self._page_to_hash.pop(p)]
            self._ref[p] = 1
            out.append(p)
        return out

    def free(self, pages: List[int]) -> None:
        """Release one reference per page; a zero-ref page returns to the
        free list, or parks in the evictable LRU if it is registered."""
        for p in pages:
            if p <= 0:
                continue
            self._ref[p] -= 1
            if self._ref[p] > 0:
                continue
            if p in self._page_to_hash:
                self._evictable[p] = None
                self._evictable.move_to_end(p)
            else:
                self._free.append(p)

    def lookup_shared(self, key: bytes) -> Optional[int]:
        """The page registered under ``key`` with a new reference taken (the
        caller co-owns it and frees it once), or None."""
        p = self._hash_to_page.get(key)
        if p is None:
            return None
        self._ref[p] += 1
        self._evictable.pop(p, None)
        return p

    def register(self, page: int, key: bytes) -> None:
        """Publish a freshly written full page under its content hash. A key
        already cached keeps its page: the first writer wins."""
        if key in self._hash_to_page or page in self._page_to_hash:
            return
        self._hash_to_page[key] = page
        self._page_to_hash[page] = key

    @property
    def free_pages(self) -> int:
        return len(self._free) + len(self._evictable)


def _full_layers(config: ModelConfig) -> bool:
    """Whether any layer of a windowed config attends to every slot (Gemma-2
    alternates sliding and full layers)."""
    return config.layer_types is not None and any(
        t != "sliding_attention" for t in config.layer_types)


@functools.lru_cache(maxsize=None)
def paged_route(config: ModelConfig, capacity: int, pool_dtype: torch.dtype):
    """("kernel" | "gather", reason): the attention route of every paged
    decode and verify body over a table of ``capacity`` slots and pools of
    ``pool_dtype``. The kernels (K3, K4) attend to every slot up to the
    query's own, uncapped, over fp pages, at the head layouts they take; the
    rest is the gather route, as in the JAX engine. A window of at least the
    table's capacity masks nothing (slot > pos - w follows from slot <
    capacity <= w), so it keeps the kernel."""
    if pool_dtype == torch.int8:
        return "gather", "int8 pages: no kernel reads them"
    if config.attn_logit_softcapping is not None:
        return "gather", (f"attention softcap {config.attn_logit_softcapping:g}: "
                          "the kernels cannot cap")
    windows = {config.layer_window(li) for li in range(config.num_hidden_layers)}
    short = sorted(w for w in windows if w is not None and w < capacity)
    if short:
        return "gather", (f"a sliding window of {short[0]} slots is shorter than the "
                          f"table's {capacity}")
    why = kernel_shape_error(config.num_attention_heads, config.num_key_value_heads,
                             config.head_dim_)
    if why is not None:
        return "gather", why
    return "kernel", (f"fp pages, no softcap, every window covers the table's {capacity} "
                      f"slots, head_dim {config.head_dim_}")


def _paged_decode_fn(config: ModelConfig, plan: ModelPlan):
    """Build the one-token decode over the page pool.

    (params, toks [B], k_pages, v_pages, tables [B, P] i32, pos [B], live [B],
    k_scales=None, v_scales=None) -> logits [B, V]. pos[b] = tokens already in
    sequence b's cache (the new token's slot). The new token's K/V are written
    into the pools in place before attention; dead rows (live=0) write slot 0
    of the null page 0 and attend over length 1. With the scale pools the
    pages are int8 and the token's K/V are quantized per head. Attention takes
    :func:`paged_route`'s route for the table and pools of the call; each
    layer's window bias and the softcap apply on the gather route. The pools
    are arguments, so one body serves a second pool (the draft's, in
    speculative serving)."""
    nh = config.num_attention_heads

    def fn(params, toks, k_pages, v_pages, tables, pos, live, k_scales=None, v_scales=None):
        L, nkv, _, page_size, hd = k_pages.shape
        b = toks.shape[0]
        cos, sin = rope_cos_sin(pos[:, None], hd, config.rope_theta,
                                scaling=config.rope_scaling)  # [B, 1, hd]
        h = embed_lookup(params, toks, config)[:, None, :]  # [B, 1, d]

        alive = live > 0
        logical = (pos // page_size).long()
        offset = (pos % page_size).long()
        phys = tables.long().gather(1, logical[:, None])[:, 0]
        # dead rows all scribble on null-page slot 0: duplicate indices in the
        # scatter are harmless because that slot is never read unmasked
        phys = torch.where(alive, phys, 0)
        lengths = torch.where(alive, pos + 1, 1).to(torch.int32)
        scale = attention_scale(config)
        route, _ = paged_route(config, tables.shape[1] * page_size, k_pages.dtype)

        for li in range(config.num_hidden_layers):
            lp = params["layers"][li]
            kinds = dict(zip(PROJ_ORDER, plan[li]))
            x = norm(h, lp["input_layernorm"]["weight"], config)
            ap = lp["self_attn"]
            # as in the JAX engine, the fused low-rank flag is not threaded
            # through: decode rows stay below that kernel's 256-row threshold
            q = proj_apply(x, ap["q_proj"], kinds["q_proj"]).reshape(b, 1, nh, hd).transpose(1, 2)
            k = proj_apply(x, ap["k_proj"], kinds["k_proj"]).reshape(b, 1, nkv, hd).transpose(1, 2)
            v = proj_apply(x, ap["v_proj"], kinds["v_proj"]).reshape(b, 1, nkv, hd).transpose(1, 2)
            q, k = apply_rope(q, k, cos, sin)

            # torch applies the integer index first, so unlike numpy/JAX the
            # [B] dim of (phys, offset) stays in place: the target is [nkv, B, hd]
            kw, vw = k[:, :, 0, :].transpose(0, 1), v[:, :, 0, :].transpose(0, 1)
            q1 = q[:, :, 0, :].to(h.dtype).contiguous()  # [B, nh, hd]
            ks = vs = None
            if k_scales is not None:
                (k_pages[li][:, phys, offset], k_scales[li][:, phys, offset]) = _quantize_kv(kw)
                (v_pages[li][:, phys, offset], v_scales[li][:, phys, offset]) = _quantize_kv(vw)
                ks, vs = k_scales[li], v_scales[li]
            else:
                k_pages[li][:, phys, offset] = kw.to(k_pages.dtype)
                v_pages[li][:, phys, offset] = vw.to(v_pages.dtype)
            if route == "kernel":
                attn = paged_attention(q1, k_pages[li], v_pages[li], lengths, tables, scale)
            else:
                attn = paged_attention_gather(
                    q1[:, None], k_pages[li], v_pages[li], lengths, tables, scale,
                    window=config.layer_window(li), cap=config.attn_logit_softcapping,
                    k_scales=ks, v_scales=vs)[:, 0]
            attn = proj_apply(attn.reshape(b, 1, nh * hd), ap["o_proj"], kinds["o_proj"])
            h = attn_mlp_residual(h, attn, lp, kinds, config)

        return final_logits(h, params, config)[:, 0, :]

    return fn


_MAX_TOP_K = 64  # cap on a request's top_k (sizes the batched top-k)
_MAX_LOGPROBS = 8  # cap on a request's top-N logprobs


def sampled_rows(reqs: List[Optional["_Request"]]) -> List[int]:
    """Rows of a batch that hold a request which samples (not greedy)."""
    return [i for i, r in enumerate(reqs) if r is not None and not r.greedy]


def sampling_settings(reqs: List[Optional["_Request"]], sampled: List[int], device):
    """Per-row (temperatures, top-k, top-p) of a batch as tensors on
    ``device``; rows outside ``sampled`` keep the identity settings."""
    b = len(reqs)
    temps, ks, top_ps = torch.ones(b), torch.zeros(b, dtype=torch.long), torch.ones(b)
    for i in sampled:
        temps[i] = max(reqs[i].temperature, 1e-6)
        ks[i] = reqs[i].top_k
        top_ps[i] = reqs[i].top_p
    return temps.to(device), ks.to(device), top_ps.to(device)


def sample_tokens(logits: torch.Tensor, reqs: List[Optional["_Request"]]) -> torch.Tensor:
    """Per-row next tokens (row i <- logits[i]): argmax for greedy rows and
    rows without a request; otherwise HF-semantics temperature / top-k /
    top-p sampling, one draw from the request's generator."""
    toks = torch.argmax(logits, dim=-1)
    sampled = sampled_rows(reqs)
    if sampled:
        temps, ks, top_ps = sampling_settings(reqs, sampled, logits.device)
        filt = topk_topp_filter(logits.float() / temps[:, None], ks, top_ps, _MAX_TOP_K)
        probs = torch.softmax(filt, dim=-1)
        for i in sampled:
            toks[i] = torch.multinomial(probs[i], 1, generator=reqs[i].generator)[0]
    return toks


def token_logprobs(logits: torch.Tensor, toks: torch.Tensor):
    """The model's raw log-probabilities (fp32 log-softmax of the untempered,
    unfiltered logits, as OpenAI's ``logprobs`` reports them): per row, the
    chosen token's and the top ``_MAX_LOGPROBS`` ids and values, ranked by a
    stable sort so that tied values keep the lower id first (``lax.top_k``'s
    order). Returns host arrays (chosen [B], top_ids [B, N], top_lps [B, N])."""
    lp = torch.log_softmax(logits.float(), dim=-1)
    chosen = lp.gather(1, toks.long()[:, None])[:, 0]
    top_lps, top_ids = torch.sort(lp, dim=-1, descending=True, stable=True)
    return (chosen.cpu().numpy(), top_ids[:, :_MAX_LOGPROBS].cpu().numpy(),
            top_lps[:, :_MAX_LOGPROBS].cpu().numpy())


def apply_penalties(logits: torch.Tensor, counts: torch.Tensor, bias: torch.Tensor,
                    pres: torch.Tensor, freq: torch.Tensor, reps: torch.Tensor) -> torch.Tensor:
    """Context-dependent logit adjustments of [N, V] rows, in the JAX
    engine's order of operations (fp32):

    - ``bias``: dense per-row logit offsets (OpenAI ``logit_bias``), first;
    - ``reps``: HF repetition penalty, a seen token's (biased) logit divided
      by the penalty when >= 0, multiplied when < 0;
    - ``pres``/``freq``: OpenAI presence and frequency penalties, minus
      ``counts * freq`` then minus ``seen * pres``.

    counts: [N, V] token counts over prompt and generated tokens. Identity
    settings (bias 0, rep 1, pres and freq 0) return the logits' fp32 values
    exactly."""
    l = logits.float() + bias
    seen = counts > 0
    pen = torch.where(l < 0, l * reps[:, None], l / reps[:, None])
    l = torch.where(seen, pen, l)
    return l - counts.float() * freq[:, None] - seen * pres[:, None]


def mask_guided(adj: torch.Tensor, allowed: torch.Tensor, accepting: torch.Tensor,
                eos_mask: torch.Tensor, flags: torch.Tensor) -> torch.Tensor:
    """Mask [N, V] adjusted logits to a grammar's allowed tokens: ``allowed``
    [N, V] the tokens each row's DFA state can consume, ``accepting`` [N]
    whether that state accepts (eos is allowed exactly there), ``eos_mask``
    [V] the stop ids; a row whose state allows nothing (a holey vocabulary)
    is forced to eos. Rows with ``flags`` False are left as they are."""
    rowmask = allowed | (eos_mask[None, :] & accepting[:, None])
    starved = ~rowmask.any(dim=-1)
    rowmask = rowmask | (eos_mask[None, :] & starved[:, None])
    return torch.where(flags[:, None] & ~rowmask, torch.finfo(torch.float32).min, adj)


class _Request:
    __slots__ = ("rid", "prompt", "pages", "pos", "out", "max_new", "done", "row",
                 "temperature", "top_k", "top_p", "seed", "generator", "finish", "logprobs",
                 "lp", "presence_penalty", "frequency_penalty", "repetition_penalty", "min_p",
                 "logit_bias", "guided", "gstate", "freed_pages", "reserved")

    def __init__(self, rid, prompt, max_new, temperature=0.0, top_k=0, top_p=1.0, seed=0,
                 logprobs=0, presence_penalty=0.0, frequency_penalty=0.0,
                 repetition_penalty=1.0, min_p=0.0, logit_bias=None):
        self.rid = rid
        self.prompt = np.asarray(prompt).reshape(-1).astype(np.int32)
        self.pages: List[int] = []
        self.pos = 0          # tokens currently in cache
        self.out: List[int] = []
        self.max_new = max_new
        self.done = False
        self.row = -1         # batch slot while live
        self.temperature = float(temperature)
        self.top_k = int(top_k)
        self.top_p = float(top_p)
        self.seed = 0 if seed is None else int(seed)
        self.generator: Optional[torch.Generator] = None  # made at admission
        self.finish = "length"  # why the request retired: eos/length/cancel
        self.logprobs = int(logprobs)  # top-N logprobs per token (0 = off)
        self.lp: List[tuple] = []      # (chosen_lp, top_ids, top_lps) per out token
        self.presence_penalty = float(presence_penalty)
        self.frequency_penalty = float(frequency_penalty)
        self.repetition_penalty = float(repetition_penalty)
        self.min_p = float(min_p)
        self.logit_bias = dict(logit_bias) if logit_bias else None
        self.guided = None      # CompiledGrammar while guided, else None
        self.gstate = 0         # the grammar DFA's current state
        self.freed_pages = 0    # leading logical pages recycled (sliding window)
        self.reserved = 0       # pages reserved against the pool (lazy allocation)

    @property
    def greedy(self) -> bool:
        return self.temperature == 0.0 or self.top_k == 1

    @property
    def penalized(self) -> bool:
        """Picks through the penalized sampler (counts and bias rows)."""
        return (self.presence_penalty != 0.0 or self.frequency_penalty != 0.0
                or self.repetition_penalty != 1.0 or self.min_p > 0.0
                or self.logit_bias is not None or self.guided is not None)


def _planes(pool: PagePool):
    """(pool array, cache key) of each plane a page holds."""
    planes = [(pool.k_pages, "k"), (pool.v_pages, "v")]
    if pool.quantized:
        planes += [(pool.k_scales, "k_scale"), (pool.v_scales, "v_scale")]
    return planes


def _build_gather(pool: PagePool, cache, shared: torch.Tensor) -> None:
    """Copy the K/V (and int8 scales) of the cached pages ``shared`` (n page
    ids, in prompt order) into slots [0, n * page_size) of a dense prefill
    cache ([1, nkv, s_pad, last] per layer), in place."""
    prefix_len = shared.shape[0] * pool.page_size
    for li, kv in enumerate(cache):
        for pages, name in _planes(pool):
            # one advanced index on dim 1 stays in place: [nkv, n, ps, last]
            pk = pages[li][:, shared]
            kv[name][0, :, :prefix_len] = pk.reshape(pk.shape[0], prefix_len, pk.shape[-1])


def _build_scatter(pool: PagePool, cache, phys: torch.Tensor, prefix_len: int = 0) -> None:
    """Write slots [prefix_len, s_pad) of a prefilled dense cache ([1, nkv,
    s_pad, last] per layer; an int8 pool's values and scales land verbatim)
    into the pages ``phys`` (the suffix's n pages) of every layer of
    ``pool``, in place."""
    n = phys.shape[0]
    for li, kv in enumerate(cache):
        for pages, name in _planes(pool):
            a = kv[name][0, :, prefix_len:]
            pages[li][:, phys] = a.reshape(a.shape[0], n, pool.page_size,
                                           a.shape[-1]).to(pages.dtype)


class _Admission:
    """An admission in flight: the request, its row, its temporary dense
    prefill cache, the prefix served from cached pages and how far the
    prompt has been prefilled."""

    __slots__ = ("req", "row", "s_pad", "prefix_len", "keys", "cache", "filled")

    def __init__(self, req, row, s_pad, prefix_len, keys, cache):
        self.req = req
        self.row = row
        self.s_pad = s_pad
        self.prefix_len = prefix_len
        self.keys = keys
        self.cache = cache
        self.filled = prefix_len  # tokens already in the temporary cache


_MAX_BIAS_ENTRIES = 300  # a request's logit_bias entries (OpenAI's cap)


class ServingEngine:
    """Continuous-batching server over the paged KV pool.

    submit() enqueues; step() admits pending requests (prefill into freshly
    allocated pages) and advances every live row one token; finished
    requests free their pages immediately; collect() drains outputs.
    ``decode_steps`` counts batched decode steps (each runs every layer's
    attention kernel once), ``decode_seconds`` their host time up to the
    sampled tokens reaching the host.

    ``prefix_cache``: full prompt pages are shared between requests by
    content (``prefix_tokens_saved`` of ``prefix_tokens_total`` prompt tokens
    skipped the prefill). ``prefill_chunk`` (a positive multiple of
    ``page_size``): admission prefills that many tokens per step() while the
    live rows keep decoding. ``tokenizer`` maps token ids to bytes for
    ``guided_regex``. ``route`` is :func:`paged_route`'s (route, reason) for
    the engine's table and pool.

    When every layer slides (``_window_recycle``), rows recycle the pages
    their later queries are masked from and allocate generation pages as
    they reach them (``_lazy_pages``): a request may span more pages than the
    pool holds, so long as its peak (:meth:`_bounded_need`) fits."""

    def __init__(self, params: Params, config: ModelConfig, plan: Optional[ModelPlan] = None,
                 *, device, num_pages: int = 64, page_size: int = 128, max_batch: int = 8,
                 max_pages_per_seq: int = 8, eos_token_id=None, quantized_kv: bool = False,
                 prefix_cache: bool = False, prefill_chunk: Optional[int] = None,
                 tokenizer=None):
        if prefill_chunk is not None and (prefill_chunk <= 0 or prefill_chunk % page_size):
            raise ValueError(f"prefill_chunk={prefill_chunk} must be a positive multiple "
                             f"of page_size={page_size}")
        self.params = params
        self.config = config
        self.plan = plan or default_plan(config)
        self.device = torch.device(device)
        self.pool = PagePool(config, num_pages, page_size, device=self.device,
                             quantized=quantized_kv)
        self.route = paged_route(config, max_pages_per_seq * page_size, self.pool.k_pages.dtype)
        # a full-attention layer reads every slot, so pages recycle only
        # when every layer slides
        self._window_recycle = None if _full_layers(config) else config.sliding_window
        # windowed rows allocate generation pages as they reach them and
        # reserve their peak at admission, so the pool is never overcommitted
        # (rows admitted against free pages alone could exhaust it in
        # lockstep before recycling starts, and all stall for good); an
        # engine whose step does not stall (the speculative one) turns this off
        self._lazy_pages = self._window_recycle is not None
        self._reserved_pages = 0
        self.max_batch = max_batch
        self.max_pages_per_seq = max_pages_per_seq
        if eos_token_id is None:
            self._eos = frozenset()
        elif isinstance(eos_token_id, (int, np.integer)):
            self._eos = frozenset([int(eos_token_id)])
        else:
            self._eos = frozenset(int(t) for t in eos_token_id)
        self.prefix_cache = bool(prefix_cache)
        self.prefix_tokens_saved = 0  # prompt tokens served from cached pages
        self.prefix_tokens_total = 0  # prompt tokens admitted
        self.prefill_chunk = prefill_chunk
        self._admitting: Dict[int, _Admission] = {}  # row -> admission in flight
        # per-row token counts and dense logit bias of the penalized pick,
        # [max_batch, V] on the device, made at the first penalized admission
        self._counts: Optional[torch.Tensor] = None
        self._bias: Optional[torch.Tensor] = None
        self.tokenizer = tokenizer
        self._grammars: Dict[str, object] = {}  # guided_regex -> CompiledGrammar
        self._token_bytes = None
        self._eos_mask: Optional[torch.Tensor] = None
        self._decode = _paged_decode_fn(config, self.plan)
        self._pending: List[_Request] = []
        self._live: List[Optional[_Request]] = [None] * max_batch
        self._finished: List[_Request] = []
        self._next_tok = np.zeros(max_batch, np.int32)
        # a row's logprob record of its pending token, parked until emitted
        self._next_lp: List[Optional[tuple]] = [None] * max_batch
        self._rid = 0
        self.decode_steps = 0
        self.decode_seconds = 0.0

    # -- public API --------------------------------------------------------
    def submit(self, prompt_ids, max_new_tokens: int, temperature: float = 0.0,
               top_k: int = 0, top_p: float = 1.0, seed: Optional[int] = None,
               logprobs: int = 0, presence_penalty: float = 0.0,
               frequency_penalty: float = 0.0, repetition_penalty: float = 1.0,
               min_p: float = 0.0, logit_bias: Optional[Dict[int, float]] = None,
               guided_regex: Optional[str] = None) -> int:
        """Enqueue a request. temperature=0 decodes greedily; otherwise
        temperature/top-k/top-p sampling from a generator seeded with
        ``seed`` (default: the request id). ``logprobs=N`` (at most
        ``_MAX_LOGPROBS``) records, per emitted token, the model's
        log-probability of the chosen token and the top N (``_Request.lp``,
        read from :meth:`collect_requests`); the token choice is the same
        with and without.

        presence_penalty and frequency_penalty ([-2, 2], OpenAI semantics),
        repetition_penalty (> 0, HF semantics), min_p ([0, 1], after top-k
        and top-p) and logit_bias ({token id: offset in [-100, 100]}, at most
        300 entries) steer the pick; greedy rows take the argmax of the
        adjusted logits, and counts cover prompt and generated tokens. A
        request at the defaults gets the bits it gets without them, batched
        with penalized rows or not. guided_regex constrains the output to
        the pattern (or a prefix of it, when cut by max_new_tokens); it needs
        the engine's tokenizer and an eos id. ValueError on a bad value."""
        if top_k > _MAX_TOP_K:
            raise ValueError(f"top_k={top_k} > supported max {_MAX_TOP_K}")
        if not 0 <= logprobs <= _MAX_LOGPROBS:
            raise ValueError(f"logprobs={logprobs} not in [0, {_MAX_LOGPROBS}]")
        if not -2.0 <= presence_penalty <= 2.0:
            raise ValueError(f"presence_penalty={presence_penalty} not in [-2, 2]")
        if not -2.0 <= frequency_penalty <= 2.0:
            raise ValueError(f"frequency_penalty={frequency_penalty} not in [-2, 2]")
        if not repetition_penalty > 0:
            raise ValueError(f"repetition_penalty={repetition_penalty} must be > 0")
        if not 0.0 <= min_p <= 1.0:
            raise ValueError(f"min_p={min_p} not in [0, 1]")
        if logit_bias is not None:
            if len(logit_bias) > _MAX_BIAS_ENTRIES:
                raise ValueError(f"logit_bias has {len(logit_bias)} entries "
                                 f"(max {_MAX_BIAS_ENTRIES})")
            for t, v in logit_bias.items():
                if not (isinstance(t, (int, np.integer)) and 0 <= t < self.config.vocab_size):
                    raise ValueError(f"logit_bias token {t!r} out of vocab")
                if not -100.0 <= float(v) <= 100.0:
                    raise ValueError(f"logit_bias value {v} not in [-100, 100]")
        grammar = self._compile_guided(guided_regex) if guided_regex else None
        flat = np.asarray(prompt_ids).reshape(-1)
        if flat.size and (flat.min() < 0 or flat.max() >= self.config.vocab_size):
            raise ValueError(f"prompt token ids must be in [0, {self.config.vocab_size})")
        need = self._pages_needed(len(flat), max_new_tokens)
        if need > self.max_pages_per_seq:
            raise ValueError(
                f"request needs {need} pages > max_pages_per_seq={self.max_pages_per_seq}")
        peak = self._bounded_need(len(flat), max_new_tokens)
        if peak > self.pool.num_pages - 1:  # page 0 is the reserved null page
            raise ValueError(f"request needs {peak} pages but the pool only has "
                             f"{self.pool.num_pages - 1} allocatable")
        self._rid += 1
        req = _Request(self._rid, prompt_ids, max_new_tokens, temperature, top_k, top_p,
                       self._rid if seed is None else seed, logprobs,
                       presence_penalty=presence_penalty, frequency_penalty=frequency_penalty,
                       repetition_penalty=repetition_penalty, min_p=min_p,
                       logit_bias=logit_bias)
        if grammar is not None:
            req.guided = grammar
            req.gstate = grammar.start
        self._pending.append(req)
        return self._rid

    def cancel(self, rid: int) -> bool:
        """Stop a request early. A pending request finishes empty, an
        admission in flight is dropped with its pages, a live one retires
        with what it has emitted (pages freed). Returns False if the rid is
        unknown."""
        for i, r in enumerate(self._pending):
            if r.rid == rid:
                self._pending.pop(i)
                r.done = True
                r.finish = "cancel"
                self._finished.append(r)
                return True
        for row, adm in list(self._admitting.items()):
            if adm.req.rid == rid:
                del self._admitting[row]
                self._reserved_pages -= adm.req.reserved
                adm.req.reserved = 0
                self.pool.free(adm.req.pages)
                adm.req.pages = []
                adm.req.done = True
                adm.req.finish = "cancel"
                self._finished.append(adm.req)
                return True
        for r in self._live:
            if r is not None and r.rid == rid:
                r.finish = "cancel"
                self._retire(r)
                return True
        return False

    def has_work(self) -> bool:
        return (bool(self._pending) or bool(self._admitting)
                or any(r is not None for r in self._live))

    def collect_requests(self) -> List[_Request]:
        done, self._finished = self._finished, []
        return done

    def collect(self) -> Dict[int, List[int]]:
        return {r.rid: r.out for r in self.collect_requests()}

    def run(self) -> Dict[int, List[int]]:
        """Drive until all submitted requests finish; return {rid: tokens}."""
        results: Dict[int, List[int]] = {}
        while self.has_work():
            self.step()
            results.update(self.collect())
        return results

    # -- guided decoding ----------------------------------------------------
    def _compile_guided(self, pattern: str):
        """The grammar of ``pattern`` for this engine's tokenizer, compiled
        once per pattern. ValueError on an unusable pattern or engine."""
        if self.tokenizer is None:
            raise ValueError("guided_regex needs the engine's tokenizer "
                             "(ServingEngine(tokenizer=...))")
        if not self._eos:
            raise ValueError("guided_regex needs a configured eos_token_id "
                             "(it terminates the match)")
        if pattern not in self._grammars:
            if self._token_bytes is None:
                self._token_bytes = token_bytes_of(self.tokenizer, self.config.vocab_size)
            try:
                self._grammars[pattern] = CompiledGrammar(pattern, self._token_bytes)
            except ValueError:
                raise
            except Exception as e:  # a parser slip on a malformed pattern
                raise ValueError(f"bad guided_regex {pattern!r}: "
                                 f"{type(e).__name__}: {e}") from e
        return self._grammars[pattern]

    def _guided_dev(self, grammar) -> tuple:
        """(allowed [S, V] bool, accepting [S] bool) of a grammar on the
        engine's device, uploaded once and cached on the grammar."""
        cache = grammar.__dict__.setdefault("_dev_tables", {})
        key = str(self.device)
        if key not in cache:
            cache[key] = (torch.from_numpy(grammar.allowed).to(self.device),
                          torch.from_numpy(grammar.accepting).to(self.device))
        return cache[key]

    def _eos_mask_dev(self) -> torch.Tensor:
        """[V] bool mask of the stop ids on the engine's device, cached."""
        if self._eos_mask is None:
            m = torch.zeros(self.config.vocab_size, dtype=torch.bool)
            m[sorted(self._eos)] = True
            self._eos_mask = m.to(self.device)
        return self._eos_mask

    def _guided_mask(self, adj: torch.Tensor, reqs: List[Optional[_Request]]) -> torch.Tensor:
        """Mask the guided rows of ``adj``. One grammar in the batch: its
        tables live on the device and only the row states upload; several:
        a [B, V] mask built on the host."""
        guided = [(i, r) for i, r in enumerate(reqs) if r is not None and r.guided is not None]
        if not guided:
            return adj
        b = adj.shape[0]
        if len({id(r.guided) for _, r in guided}) == 1:
            table, accept = self._guided_dev(guided[0][1].guided)
            states = torch.zeros(b, dtype=torch.long)
            flags = torch.zeros(b, dtype=torch.bool)
            for i, r in guided:
                states[i], flags[i] = r.gstate, True
            states = states.to(self.device)
            return mask_guided(adj, table[states], accept[states], self._eos_mask_dev(),
                               flags.to(self.device))
        mask = np.ones(adj.shape, bool)
        for i, r in guided:
            m = r.guided.allowed[r.gstate].copy()
            acc = bool(r.guided.accepting[r.gstate])
            for e in self._eos:
                m[e] = acc
            if not m.any():  # a starved state: force eos
                for e in self._eos:
                    m[e] = True
            mask[i] = m
        return torch.where(torch.from_numpy(mask).to(self.device), adj,
                           torch.finfo(torch.float32).min)

    # -- internals ----------------------------------------------------------
    def _pages_needed(self, prompt_len: int, max_new: int) -> int:
        """Pages a request's table spans from admission to retirement."""
        return -(-(prompt_len + max_new) // self.pool.page_size)

    def _bounded_need(self, prompt_len: int, max_new: int) -> int:
        """Pages a request can ever hold at once: all it spans, or with lazy
        allocation and recycling its prompt pages plus the band of
        ceil(window / page_size) + 2 (the write page trails the first
        unexpired one by less than window + page_size slots)."""
        full = self._pages_needed(prompt_len, max_new)
        if not self._lazy_pages:
            return full
        ps = self.pool.page_size
        band = -(-self._window_recycle // ps) + 2
        return min(full, -(-max(prompt_len, 1) // ps) + band)

    def _penalty_rows(self, reqs: List[Optional[_Request]]):
        """Per-row (min_p, presence, frequency, repetition, biased) of a
        batch as fp32 tensors on the device; rows that are not penalized keep
        the identity settings and an unread bias row."""
        vals = np.zeros((5, len(reqs)), np.float32)
        vals[3] = 1.0
        for i, r in enumerate(reqs):
            if r is not None and r.penalized:
                vals[:, i] = (r.min_p, r.presence_penalty, r.frequency_penalty,
                              r.repetition_penalty, 1.0 if r.logit_bias else 0.0)
        return torch.from_numpy(vals).to(self.device).unbind(0)

    def _sample_penalized(self, logits: torch.Tensor,
                          reqs: List[Optional[_Request]]) -> torch.Tensor:
        """The penalized pick of a batch (row i <- logits[i]): bias, then
        repetition, then presence/frequency, the grammar mask, then
        temperature, top-k, top-p and min_p; greedy rows take the argmax of
        the adjusted logits. A sampled row draws once from its generator, as
        in :func:`sample_tokens`. Each pick is added to its row's counts."""
        dev = self.device
        rows = torch.tensor([r.row if r is not None else 0 for r in reqs], device=dev)
        min_ps, pres, freq, reps, biased = self._penalty_rows(reqs)
        adj = apply_penalties(logits, self._counts[rows], self._bias[rows] * biased[:, None],
                              pres, freq, reps)
        adj = self._guided_mask(adj, reqs)
        toks = torch.argmax(adj, dim=-1)
        sampled = sampled_rows(reqs)
        if sampled:
            temps, ks, top_ps = sampling_settings(reqs, sampled, dev)
            filt = topk_topp_filter(adj / temps[:, None], ks, top_ps, _MAX_TOP_K, min_ps=min_ps)
            probs = torch.softmax(filt, dim=-1)
            for i in sampled:
                toks[i] = torch.multinomial(probs[i], 1, generator=reqs[i].generator)[0]
        real = torch.tensor([i for i, r in enumerate(reqs) if r is not None], device=dev)
        self._counts.index_put_((rows[real], toks[real]),
                                torch.ones(real.shape[0], dtype=torch.int32, device=dev),
                                accumulate=True)
        return toks

    def _pick_tokens(self, logits: torch.Tensor, reqs: List[Optional[_Request]]) -> np.ndarray:
        """Per-row next tokens for ``reqs`` (row i <- logits[i]), on the host.
        A batch that holds a penalized request picks through the penalized
        sampler (its plain rows get the bits the plain sampler gives them). A
        request that wants logprobs has its record of the picked token, from
        the raw distribution, parked in ``_next_lp`` until step() emits the
        token. Guided rows advance their DFA by the pick."""
        if any(r is not None and r.penalized for r in reqs):
            toks = self._sample_penalized(logits, reqs)
        else:
            toks = sample_tokens(logits, reqs)
        if any(r is not None and r.logprobs for r in reqs):
            chosen, top_ids, top_lps = token_logprobs(logits, toks)
            for i, r in enumerate(reqs):
                if r is not None and r.logprobs:
                    k = r.logprobs
                    self._next_lp[r.row] = (float(chosen[i]), top_ids[i, :k].tolist(),
                                            top_lps[i, :k].tolist())
        toks = toks.cpu().numpy().astype(np.int32)
        for i, r in enumerate(reqs):
            if r is not None and r.guided is not None:
                self._advance_grammar(r, [int(toks[i])])
        return toks

    def _advance_grammar(self, req: _Request, toks) -> None:
        """Advance a guided request's DFA through ``toks`` up to a stop id (a
        forced eos row's state stays)."""
        for tok in toks:
            if tok in self._eos:
                return
            ns = int(req.guided.token_trans[req.gstate, tok])
            if ns >= 0:
                req.gstate = ns

    def _page_keys(self, prompt: np.ndarray, n: int) -> List[bytes]:
        """Chained content hashes: key i covers tokens [0, (i + 1) * page_size),
        so a hit on page i implies that the whole prefix through it matches."""
        ps = self.pool.page_size
        h = hashlib.blake2b(digest_size=16)
        keys = []
        for i in range(n):
            h.update(prompt[i * ps:(i + 1) * ps].tobytes())
            keys.append(h.digest())
        return keys

    def _prefill_into(self, pool: PagePool, params: Params, config: ModelConfig,
                      plan: ModelPlan, req: _Request, prefix_len: int = 0) -> torch.Tensor:
        """Prefill ``req``'s prompt (padded to whole pages) with one model
        into the request's pages of ``pool``, in one forward: the first
        ``prefix_len`` slots come from the cached pages that open the
        request's table, the rest run the model at that offset and scatter
        into the pages after them. Returns the suffix's logits."""
        ps = pool.page_size
        s = len(req.prompt)
        s_pad = -(-max(s, 1) // ps) * ps
        hits = prefix_len // ps
        cache = self._temp_cache(pool, config, s_pad, req.pages[:hits])
        ids = np.zeros((1, s_pad - prefix_len), np.int64)
        ids[0, :s - prefix_len] = req.prompt[prefix_len:]
        logits, cache = _forward_with_cache(params, torch.from_numpy(ids).to(self.device), cache,
                                            prefix_len, config=config, plan=plan)
        _build_scatter(pool, cache, self._ids(req.pages[hits:s_pad // ps]), prefix_len)
        return logits

    def _ids(self, values: List[int]) -> torch.Tensor:
        """A long tensor of ids (pages, rows, tokens) on the engine's device."""
        return torch.tensor(values, dtype=torch.long, device=self.device)

    def _temp_cache(self, pool: PagePool, config: ModelConfig, s_pad: int, shared: List[int]):
        """A dense prefill cache of ``s_pad`` slots in the pool's dtype (an
        int8 pool prefills over an int8 cache, so that the prompt's attention
        reads the quantized K/V its decode will read and the pool receives
        those values and scales verbatim), its first slots gathered from the
        cached pages ``shared``."""
        cache = init_kv_cache(config, 1, s_pad, device=self.device, dtype=pool.k_pages.dtype,
                              quantized=pool.quantized)
        if shared:
            _build_gather(pool, cache, self._ids(shared))
        return cache

    def _admit(self, req: _Request, row: int) -> None:
        """Admit ``req`` into ``row``: pages, prefill, first token. With
        ``prefill_chunk`` only the first chunk runs here; the admission then
        waits in ``_admitting`` and step() advances it a chunk at a time."""
        adm = self._admit_start(req, row)
        if not self._admit_chunk(adm):
            self._admitting[row] = adm

    def _admit_start(self, req: _Request, row: int) -> _Admission:
        """Look up the prompt's cached pages, allocate the rest, seed the
        penalized pick's rows and gather the cached prefix into the
        temporary prefill cache."""
        ps = self.pool.page_size
        s = len(req.prompt)
        s_pad = -(-max(s, 1) // ps) * ps
        shared: List[int] = []
        keys: List[bytes] = []
        if self.prefix_cache:
            # only pages fully inside the prompt minus its last token: the
            # suffix prefill is never empty, and the page decode first
            # writes (slot s) stays private
            keys = self._page_keys(req.prompt, (s - 1) // ps)
            for key in keys:
                p = self.pool.lookup_shared(key)
                if p is None:
                    break
                shared.append(p)
            self.prefix_tokens_saved += len(shared) * ps
            self.prefix_tokens_total += s
        # lazily allocated rows take their prompt's pages now, the rest as
        # decoding reaches them
        need = s_pad // ps if self._lazy_pages else self._pages_needed(s, req.max_new)
        try:
            req.pages = shared + self.pool.alloc(need - len(shared))
        except MemoryError:
            self.pool.free(shared)  # give the cache's references back
            raise
        if self._lazy_pages:
            # reserved at once: a chunked admission spans steps, and other
            # admissions must see this row's claim on the pool meanwhile
            req.reserved = self._bounded_need(s, req.max_new)
            self._reserved_pages += req.reserved
        if not req.greedy:
            req.generator = torch.Generator(device=self.device).manual_seed(req.seed)
        if req.penalized:
            # counts start as the prompt's histogram (penalties cover prompt
            # and generated tokens), bias as the request's dense offsets
            v = self.config.vocab_size
            if self._counts is None:
                self._counts = torch.zeros((self.max_batch, v), dtype=torch.int32,
                                           device=self.device)
                self._bias = torch.zeros((self.max_batch, v), dtype=torch.float32,
                                         device=self.device)
            hist = np.bincount(req.prompt, minlength=v).astype(np.int32)
            self._counts[row] = torch.from_numpy(hist).to(self.device)
            bias = np.zeros(v, np.float32)
            for t, val in (req.logit_bias or {}).items():
                bias[int(t)] = float(val)
            self._bias[row] = torch.from_numpy(bias).to(self.device)
        cache = self._temp_cache(self.pool, self.config, s_pad, shared)
        return _Admission(req, row, s_pad, len(shared) * ps, keys, cache)

    def _admit_chunk(self, adm: _Admission) -> bool:
        """Prefill the next chunk at cache offset ``adm.filled``; after the
        last one, finish the admission. True when the row is live."""
        req, s = adm.req, len(adm.req.prompt)
        f = adm.filled
        c = min(self.prefill_chunk or (adm.s_pad - f), adm.s_pad - f)
        ids = np.zeros((1, c), np.int64)
        n_real = max(0, min(s, f + c) - f)
        ids[0, :n_real] = req.prompt[f:f + n_real]
        logits, adm.cache = _forward_with_cache(
            self.params, torch.from_numpy(ids).to(self.device), adm.cache, f,
            config=self.config, plan=self.plan)
        adm.filled = f + c
        if adm.filled < adm.s_pad:
            return False
        self._admit_finish(adm, logits, f)
        return True

    def _admit_finish(self, adm: _Admission, logits: torch.Tensor, f: int) -> None:
        """Scatter the suffix pages, publish the new full pages, activate the
        row and pick its first token from the last prompt position (always
        in the final chunk [f, s_pad))."""
        ps = self.pool.page_size
        req, row = adm.req, adm.row
        s, hits = len(req.prompt), adm.prefix_len // ps
        _build_scatter(self.pool, adm.cache, self._ids(req.pages[hits:adm.s_pad // ps]),
                       adm.prefix_len)
        if self.prefix_cache:
            for j in range(hits, len(adm.keys)):
                self.pool.register(req.pages[j], adm.keys[j])
        adm.cache = None  # release the temporary cache
        req.pos = s
        req.row = row
        self._live[row] = req
        self._next_tok[row] = int(self._pick_tokens(logits[:, (s - 1) - f], [req])[0])

    def _admit_pending(self) -> None:
        """Admit pending requests into free rows while pages suffice: free
        pages, or with lazy allocation the pages no admitted row has
        reserved (every live row may still grow to its peak)."""
        for row in range(self.max_batch):
            if self._live[row] is None and row not in self._admitting and self._pending:
                nxt = self._pending[0]
                need = self._bounded_need(len(nxt.prompt), nxt.max_new)
                room = ((self.pool.num_pages - 1) - self._reserved_pages if self._lazy_pages
                        else self.pool.free_pages)
                if need > room:
                    break  # wait for pages to free up
                self._admit(self._pending.pop(0), row)

    def _ensure_pages(self) -> set:
        """Give each live row a page for its write slot; a row whose page the
        pool cannot give now stalls this step. Returns the stalled rids."""
        stalled = set()
        for r in self._live:
            if r is None:
                continue
            while len(r.pages) <= r.pos // self.pool.page_size:
                if self.pool.free_pages == 0:
                    stalled.add(r.rid)
                    break
                r.pages.extend(self.pool.alloc(1))
        return stalled

    def _batch_state(self, stalled=frozenset()):
        """(tables [max_batch, pages_per_seq], pos, live) of the live rows
        that are not ``stalled``, int32 numpy."""
        tables = np.zeros((self.max_batch, self.max_pages_per_seq), np.int32)
        pos = np.zeros(self.max_batch, np.int32)
        live = np.zeros(self.max_batch, np.int32)
        for r in self._live:
            if r is None or r.rid in stalled:
                continue
            tables[r.row, :len(r.pages)] = r.pages
            pos[r.row] = r.pos
            live[r.row] = 1
        return tables, pos, live

    def step(self) -> None:
        # admissions in flight advance one chunk each; live rows decode below
        for row, adm in list(self._admitting.items()):
            if self._admit_chunk(adm):
                del self._admitting[row]
        self._admit_pending()
        stalled = self._ensure_pages()

        # emit the token computed last step (or by prefill), check stops
        for r in list(self._live):
            if r is None or r.rid in stalled:
                continue
            self._emit(r, int(self._next_tok[r.row]))

        tables, pos, live = self._batch_state(stalled)
        if not live.any():
            return

        t0 = time.perf_counter()
        dev = self.device
        logits = self._decode(
            self.params, torch.from_numpy(self._next_tok.astype(np.int64)).to(dev),
            self.pool.k_pages, self.pool.v_pages, torch.from_numpy(tables).to(dev),
            torch.from_numpy(pos).to(dev), torch.from_numpy(live).to(dev),
            self.pool.k_scales, self.pool.v_scales)
        # a stalled row draws nothing from its generator for a token it drops
        nxt = self._pick_tokens(logits, [None if r is not None and r.rid in stalled else r
                                         for r in self._live])
        self.decode_seconds += time.perf_counter() - t0
        self.decode_steps += 1
        for r in list(self._live):
            if r is None or r.rid in stalled:
                continue
            r.pos += 1
            self._recycle_window_pages(r)
            self._next_tok[r.row] = nxt[r.row]
            if len(r.out) >= r.max_new:
                self._retire(r)

    def _recycle_window_pages(self, r: _Request) -> None:
        """Return the pages every later query of the row is masked from: with
        visibility slot > pos - window, logical page l expires once
        (l + 1) * page_size - 1 <= pos - window; its table entry becomes the
        null page (reads of it are masked, writes go to the current page)."""
        w = self._window_recycle
        if w is None:
            return
        exp = min(max(0, (r.pos - w + 1) // self.pool.page_size), len(r.pages))
        for l in range(r.freed_pages, exp):
            self.pool.free([r.pages[l]])
            r.pages[l] = 0
        r.freed_pages = max(r.freed_pages, exp)

    def _emit(self, req: _Request, tok: int) -> bool:
        """Append ``tok`` to the request's output, or retire the request on a
        stop token, which is not emitted. True while the request goes on."""
        if tok in self._eos:
            req.finish = "eos"
            self._retire(req)
            return False
        req.out.append(tok)
        if req.logprobs and self._next_lp[req.row] is not None:
            req.lp.append(self._next_lp[req.row])
        return True

    def _retire(self, req: _Request) -> None:
        self._reserved_pages -= req.reserved
        req.reserved = 0
        self.pool.free(req.pages)
        req.pages = []
        req.done = True
        self._live[req.row] = None
        self._next_lp[req.row] = None  # not the row's next tenant's
        self._finished.append(req)
