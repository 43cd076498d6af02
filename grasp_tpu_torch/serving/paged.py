"""Paged KV cache + continuous batching (counterpart of grasp_tpu/serving/paged.py).

KV lives in a global page pool per layer, ``k_pages/v_pages: [L, nkv,
num_pages, page_size, hd]``; each sequence owns a page table (logical block ->
physical page), and a refcounted free list recycles pages the moment a
request finishes. :class:`ServingEngine` batches continuously: requests join
mid-flight (prefill into fresh pages), finished rows retire and free their
pages, and every decode step advances all live rows at once.

Decode attention reads the pages in place through the page table with the
CUDA kernel of :mod:`grasp_tpu_torch.ops.paged_attention` (its plain version
on CPU tensors). The pools are updated in place; the JAX engine donated them
to its jitted step instead.

Ported: fp pools, int8 and int4 weights (through ``proj_apply``), greedy and
temperature/top-k/top-p sampling, eos stops, cancel. The prefix cache,
chunked prefill, int8 KV, penalties, logit bias,
logprobs and guided decoding raise NotImplementedError.
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
    _lm_logits,
    apply_rope,
    attention_scale,
    attn_mlp_residual,
    check_supported,
    default_plan,
    embed_lookup,
    init_kv_cache,
    prefill,
    proj_apply,
    rms_norm,
    rope_cos_sin,
    torch_dtype,
)
from grasp_tpu_torch.ops.paged_attention import check_kernel_shape, paged_attention


class PagePool:
    """Global KV page pool (device) + host-side refcounting allocator.
    Page 0 is the reserved null page that unallocated table slots and dead
    rows point at."""

    def __init__(self, config: ModelConfig, num_pages: int, page_size: int = 128, *,
                 device, dtype: Optional[torch.dtype] = None):
        self.config = config
        self.num_pages = num_pages
        self.page_size = page_size
        dtype = dtype or torch_dtype(config.dtype)
        # [L, nkv, P, ps, hd]: each layer's slice is the kernel's
        # [num_kv_heads, total_pages, page_size, head_dim]
        shape = (config.num_hidden_layers, config.num_key_value_heads, num_pages,
                 page_size, config.head_dim_)
        self.k_pages = torch.zeros(shape, dtype=dtype, device=device)
        self.v_pages = torch.zeros(shape, dtype=dtype, device=device)
        self._free: List[int] = list(range(num_pages - 1, 0, -1))
        self._ref = [0] * num_pages

    def alloc(self, n: int) -> List[int]:
        if n > self.free_pages:
            raise MemoryError(f"page pool exhausted: need {n}, have {self.free_pages} free")
        out = [self._free.pop() for _ in range(n)]
        for p in out:
            self._ref[p] = 1
        return out

    def free(self, pages: List[int]) -> None:
        """Release one reference per page; a zero-ref page returns to the
        free list."""
        for p in pages:
            if p <= 0:
                continue
            self._ref[p] -= 1
            if self._ref[p] == 0:
                self._free.append(p)

    @property
    def free_pages(self) -> int:
        return len(self._free)


def _paged_decode_fn(config: ModelConfig, plan: ModelPlan):
    """Build the one-token decode over the page pool.

    (params, toks [B], k_pages, v_pages, tables [B, P] i32, pos [B], live [B])
    -> logits [B, V]. pos[b] = tokens already in sequence b's cache (the new
    token's slot). The new token's K/V are written into the pools in place
    before attention; dead rows (live=0) write slot 0 of the null page 0 and
    attend over length 1."""
    nh = config.num_attention_heads

    def fn(params, toks, k_pages, v_pages, tables, pos, live):
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

        for li in range(config.num_hidden_layers):
            lp = params["layers"][li]
            kinds = dict(zip(PROJ_ORDER, plan[li]))
            x = rms_norm(h, lp["input_layernorm"]["weight"], config.rms_norm_eps)
            ap = lp["self_attn"]
            # as in the JAX engine, the fused low-rank flag is not threaded
            # through: decode rows stay below that kernel's 256-row threshold
            q = proj_apply(x, ap["q_proj"], kinds["q_proj"]).reshape(b, 1, nh, hd).transpose(1, 2)
            k = proj_apply(x, ap["k_proj"], kinds["k_proj"]).reshape(b, 1, nkv, hd).transpose(1, 2)
            v = proj_apply(x, ap["v_proj"], kinds["v_proj"]).reshape(b, 1, nkv, hd).transpose(1, 2)
            q, k = apply_rope(q, k, cos, sin)

            # torch applies the integer index first, so unlike numpy/JAX the
            # [B] dim of (phys, offset) stays in place: the target is [nkv, B, hd]
            k_pages[li][:, phys, offset] = k[:, :, 0, :].transpose(0, 1).to(k_pages.dtype)
            v_pages[li][:, phys, offset] = v[:, :, 0, :].transpose(0, 1).to(v_pages.dtype)

            attn = paged_attention(q[:, :, 0, :].to(h.dtype).contiguous(), k_pages[li],
                                   v_pages[li], lengths, tables, scale)  # [B, nh, hd]
            attn = proj_apply(attn.reshape(b, 1, nh * hd), ap["o_proj"], kinds["o_proj"])
            h = attn_mlp_residual(h, attn, lp, kinds, config)

        h = rms_norm(h, params["norm"]["weight"], config.rms_norm_eps)
        return _lm_logits(h, params)[:, 0, :]

    return fn


_MAX_TOP_K = 64  # cap on a request's top_k (sizes the batched top-k)


def sample_tokens(logits: torch.Tensor, reqs: List[Optional["_Request"]]) -> torch.Tensor:
    """Per-row next tokens (row i <- logits[i]): argmax for greedy rows and
    rows without a request; otherwise HF-semantics temperature / top-k /
    top-p sampling, one draw from the request's generator."""
    toks = torch.argmax(logits, dim=-1)
    sampled = [i for i, r in enumerate(reqs) if r is not None and not r.greedy]
    if sampled:
        b = logits.shape[0]
        temps, ks, top_ps = torch.ones(b), torch.zeros(b, dtype=torch.long), torch.ones(b)
        for i in sampled:
            temps[i] = max(reqs[i].temperature, 1e-6)
            ks[i] = reqs[i].top_k
            top_ps[i] = reqs[i].top_p
        dev = logits.device
        filt = topk_topp_filter(logits.float() / temps.to(dev)[:, None], ks.to(dev),
                                top_ps.to(dev), _MAX_TOP_K)
        probs = torch.softmax(filt, dim=-1)
        for i in sampled:
            toks[i] = torch.multinomial(probs[i], 1, generator=reqs[i].generator)[0]
    return toks


class _Request:
    __slots__ = ("rid", "prompt", "pages", "pos", "out", "max_new", "done", "row",
                 "temperature", "top_k", "top_p", "seed", "generator", "finish")

    def __init__(self, rid, prompt, max_new, temperature=0.0, top_k=0, top_p=1.0, seed=0):
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

    @property
    def greedy(self) -> bool:
        return self.temperature == 0.0 or self.top_k == 1


def _build_scatter(k_pages: torch.Tensor, v_pages: torch.Tensor, cache, phys: torch.Tensor,
                   page_size: int) -> None:
    """Write a prefilled dense cache ([1, nkv, n*ps, hd] per layer) into the
    pages ``phys`` (n of them) of every layer, in place."""
    n = phys.shape[0]
    for li, kv in enumerate(cache):
        for pages, arr in ((k_pages, kv["k"]), (v_pages, kv["v"])):
            a = arr[0]
            pages[li][:, phys] = a.reshape(a.shape[0], n, page_size, a.shape[-1]).to(pages.dtype)


_UNSUPPORTED_SUBMIT = {
    "logprobs": 0, "presence_penalty": 0.0, "frequency_penalty": 0.0,
    "repetition_penalty": 1.0, "min_p": 0.0, "logit_bias": None, "guided_regex": None,
}


class ServingEngine:
    """Continuous-batching server over the paged KV pool.

    submit() enqueues; step() admits pending requests (prefill into freshly
    allocated pages) and advances every live row one token; finished
    requests free their pages immediately; collect() drains outputs.
    ``decode_steps`` counts batched decode steps (each runs every layer's
    attention kernel once), ``decode_seconds`` their host time up to the
    sampled tokens reaching the host."""

    def __init__(self, params: Params, config: ModelConfig, plan: Optional[ModelPlan] = None,
                 *, device, num_pages: int = 64, page_size: int = 128, max_batch: int = 8,
                 max_pages_per_seq: int = 8, eos_token_id=None, quantized_kv: bool = False,
                 prefix_cache: bool = False, prefill_chunk: Optional[int] = None):
        check_supported(config)
        for name, on in (("quantized_kv", quantized_kv), ("prefix_cache", prefix_cache),
                         ("prefill_chunk", prefill_chunk is not None)):
            if on:
                raise NotImplementedError(f"grasp_tpu_torch serving does not support {name} yet")
        self.params = params
        self.config = config
        self.plan = plan or default_plan(config)
        self.device = torch.device(device)
        if self.device.type == "cuda":
            check_kernel_shape(config.num_attention_heads, config.num_key_value_heads,
                               config.head_dim_)
        self.pool = PagePool(config, num_pages, page_size, device=self.device)
        self.max_batch = max_batch
        self.max_pages_per_seq = max_pages_per_seq
        if eos_token_id is None:
            self._eos = frozenset()
        elif isinstance(eos_token_id, (int, np.integer)):
            self._eos = frozenset([int(eos_token_id)])
        else:
            self._eos = frozenset(int(t) for t in eos_token_id)
        self._decode = _paged_decode_fn(config, self.plan)
        self._pending: List[_Request] = []
        self._live: List[Optional[_Request]] = [None] * max_batch
        self._finished: List[_Request] = []
        self._next_tok = np.zeros(max_batch, np.int32)
        self._rid = 0
        self.decode_steps = 0
        self.decode_seconds = 0.0

    # -- public API --------------------------------------------------------
    def submit(self, prompt_ids, max_new_tokens: int, temperature: float = 0.0,
               top_k: int = 0, top_p: float = 1.0, seed: Optional[int] = None,
               **unsupported) -> int:
        """Enqueue a request. temperature=0 decodes greedily; otherwise
        temperature/top-k/top-p sampling from a generator seeded with
        ``seed`` (default: the request id). Penalties, logit_bias, logprobs
        and guided decoding raise NotImplementedError unless left at their
        defaults."""
        for name, value in unsupported.items():
            if name not in _UNSUPPORTED_SUBMIT:
                raise TypeError(f"submit() got an unexpected keyword argument {name!r}")
            if value != _UNSUPPORTED_SUBMIT[name]:
                raise NotImplementedError(f"grasp_tpu_torch serving does not support {name} yet")
        if top_k > _MAX_TOP_K:
            raise ValueError(f"top_k={top_k} > supported max {_MAX_TOP_K}")
        flat = np.asarray(prompt_ids).reshape(-1)
        if flat.size and (flat.min() < 0 or flat.max() >= self.config.vocab_size):
            raise ValueError(f"prompt token ids must be in [0, {self.config.vocab_size})")
        need = -(-(len(flat) + max_new_tokens) // self.pool.page_size)
        if need > self.max_pages_per_seq:
            raise ValueError(
                f"request needs {need} pages > max_pages_per_seq={self.max_pages_per_seq}")
        if need > self.pool.num_pages - 1:  # page 0 is the reserved null page
            raise ValueError(f"request needs {need} pages but the pool only has "
                             f"{self.pool.num_pages - 1} allocatable")
        self._rid += 1
        self._pending.append(_Request(self._rid, prompt_ids, max_new_tokens, temperature,
                                      top_k, top_p, self._rid if seed is None else seed))
        return self._rid

    def cancel(self, rid: int) -> bool:
        """Stop a request early. A pending request finishes empty; a live one
        retires with what it has emitted (pages freed). Returns False if the
        rid is unknown."""
        for i, r in enumerate(self._pending):
            if r.rid == rid:
                self._pending.pop(i)
                r.done = True
                r.finish = "cancel"
                self._finished.append(r)
                return True
        for r in self._live:
            if r is not None and r.rid == rid:
                r.finish = "cancel"
                self._retire(r)
                return True
        return False

    def has_work(self) -> bool:
        return bool(self._pending) or any(r is not None for r in self._live)

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

    # -- internals ----------------------------------------------------------
    def _pick_tokens(self, logits: torch.Tensor, reqs: List[Optional[_Request]]) -> np.ndarray:
        """Per-row next tokens for ``reqs`` (row i <- logits[i]), on the host."""
        return sample_tokens(logits, reqs).cpu().numpy().astype(np.int32)

    def _admit(self, req: _Request, row: int) -> None:
        """Allocate pages, prefill the prompt (padded to whole pages) into a
        temporary dense cache, scatter it into the pages, activate the row
        and pick its first token from the last prompt position."""
        ps = self.pool.page_size
        s = len(req.prompt)
        s_pad = -(-max(s, 1) // ps) * ps
        req.pages = self.pool.alloc(-(-(s + req.max_new) // ps))
        if not req.greedy:
            req.generator = torch.Generator(device=self.device).manual_seed(req.seed)

        cache = init_kv_cache(self.config, 1, s_pad, device=self.device,
                              dtype=self.pool.k_pages.dtype)
        ids = np.zeros((1, s_pad), np.int64)
        ids[0, :s] = req.prompt
        logits, cache = prefill(self.params, torch.from_numpy(ids).to(self.device), cache,
                                config=self.config, plan=self.plan)
        phys = torch.tensor(req.pages[:s_pad // ps], dtype=torch.long, device=self.device)
        _build_scatter(self.pool.k_pages, self.pool.v_pages, cache, phys, ps)

        req.pos = s
        req.row = row
        self._live[row] = req
        self._next_tok[row] = int(self._pick_tokens(logits[:, s - 1], [req])[0])

    def step(self) -> None:
        for row in range(self.max_batch):
            if self._live[row] is None and self._pending:
                nxt = self._pending[0]
                need = -(-(len(nxt.prompt) + nxt.max_new) // self.pool.page_size)
                if need > self.pool.free_pages:
                    break  # wait for pages to free up
                self._admit(self._pending.pop(0), row)

        # emit the token computed last step (or by prefill), check stops
        for r in list(self._live):
            if r is None:
                continue
            tok = int(self._next_tok[r.row])
            if tok in self._eos:
                r.finish = "eos"
                self._retire(r)  # the stop token is not emitted
            else:
                r.out.append(tok)

        tables = np.zeros((self.max_batch, self.max_pages_per_seq), np.int32)
        pos = np.zeros(self.max_batch, np.int32)
        live = np.zeros(self.max_batch, np.int32)
        for r in self._live:
            if r is None:
                continue
            tables[r.row, :len(r.pages)] = r.pages
            pos[r.row] = r.pos
            live[r.row] = 1
        if not live.any():
            return

        t0 = time.perf_counter()
        dev = self.device
        logits = self._decode(
            self.params, torch.from_numpy(self._next_tok.astype(np.int64)).to(dev),
            self.pool.k_pages, self.pool.v_pages, torch.from_numpy(tables).to(dev),
            torch.from_numpy(pos).to(dev), torch.from_numpy(live).to(dev))
        nxt = self._pick_tokens(logits, self._live)
        self.decode_seconds += time.perf_counter() - t0
        self.decode_steps += 1
        for r in list(self._live):
            if r is None:
                continue
            r.pos += 1
            self._next_tok[r.row] = nxt[r.row]
            if len(r.out) >= r.max_new:
                self._retire(r)

    def _retire(self, req: _Request) -> None:
        self.pool.free(req.pages)
        req.pages = []
        req.done = True
        self._live[req.row] = None
        self._finished.append(req)
