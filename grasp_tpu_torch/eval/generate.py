"""Autoregressive generation over the dense KV cache (counterpart of
grasp_tpu/eval/generate.py).

  - the prompt is right-padded to a multiple of 128 tokens for the prefill,
    and the cache holds ``round_up(prompt + max_new_tokens, 128)`` slots, as
    in the JAX package, so both see the same shapes;
  - pad slots past the live prefix are excluded by the causal mask (a query
    at position t attends keys <= t; a pad entry sits at an index > t until a
    generated token overwrites it);
  - a stop token is never emitted, and stops only count once
    ``min_new_tokens`` tokens have been emitted.

The JAX package decodes inside one ``lax.while_loop`` (its device loop) and
pins it equal to its Python loop; here one host loop with the device loop's
semantics decodes one token a step, so ``device_loop`` selects nothing. The
reference evaluates greedily everywhere (``do_sample=False``):
:class:`Generator` is the parity surface; :class:`SamplingGenerator` and the
int8 KV cache are serving extensions. Generation takes no paged kernel and no
flash route (a forward with a cache attends through its mask); a prefill of
256 rows or more runs a low-rank projection through the fused kernel when the
config asks for it.
"""

from __future__ import annotations

from typing import List, Optional, Sequence

import numpy as np
import torch

from grasp_tpu_torch.configs import ModelConfig
from grasp_tpu_torch.eval.ppl import params_device
from grasp_tpu_torch.models.llama import (
    ModelPlan,
    Params,
    decode_step,
    default_plan,
    init_kv_cache,
    prefill,
)

_PREFILL_BUCKET = 128
# the JAX device loop compares against a stop list of 4 ids
_MAX_STOPS = 4


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


def _stop_ids(eos_token_id: Optional[int], extra: Sequence[int] = ()) -> List[int]:
    return (([eos_token_id] if eos_token_id is not None else []) + list(extra))[:_MAX_STOPS]


class Generator:
    """Greedy generation from one prompt (:meth:`greedy`) or a batch of
    left-padded prompts (:meth:`greedy_batch`) on the device of ``params``.
    ``mesh``: ``params`` tensor-parallel on it (parallel.mesh.shard_params);
    every rank generates the same tokens."""

    def __init__(self, params: Params, config: ModelConfig, plan: Optional[ModelPlan] = None,
                 device_loop: bool = True, quantized_kv: bool = False, mesh=None):
        self.params = params
        self.mesh = mesh
        self.config = config
        self.plan = plan or default_plan(config)
        self.device_loop = device_loop
        # int8 KV cache (models.llama.init_kv_cache quantized=True)
        self.quantized_kv = quantized_kv
        self.device = params_device(params)

    def _prefill_one(self, prompt_ids: np.ndarray, max_new_tokens: int):
        """Prefill of one prompt: (prompt length, cache length, last-position
        logits [V], cache)."""
        ids = np.asarray(prompt_ids).reshape(-1)
        s = ids.shape[0]
        s_pad = _round_up(max(s, 1), _PREFILL_BUCKET)
        cache_len = _round_up(s + max_new_tokens, _PREFILL_BUCKET)
        padded = torch.zeros((1, s_pad), dtype=torch.long)
        padded[0, :s] = torch.as_tensor(ids, dtype=torch.long)
        cache = init_kv_cache(self.config, 1, cache_len, device=self.device,
                              quantized=self.quantized_kv, mesh=self.mesh)
        logits, cache = prefill(self.params, padded.to(self.device), cache, config=self.config,
                                plan=self.plan, mesh=self.mesh)
        return s, cache_len, logits[0, s - 1], cache

    def _decode(self, toks: torch.Tensor, cache, index: int, **kw) -> torch.Tensor:
        """One decode step of ``toks`` [B] at cache slot ``index``; the last
        logits [B, V]."""
        logits, _ = decode_step(self.params, toks[:, None], cache, index, config=self.config,
                                plan=self.plan, mesh=self.mesh, **kw)
        return logits[:, 0]

    @torch.no_grad()
    def greedy(self, prompt_ids: np.ndarray, max_new_tokens: int,
               eos_token_id: Optional[int] = None, min_new_tokens: int = 0,
               extra_stop_ids: Optional[List[int]] = None) -> List[int]:
        """Greedy continuation of one prompt ([S] or [1, S]); the new ids."""
        s, _, logits, cache = self._prefill_one(prompt_ids, max_new_tokens)
        first = int(torch.argmax(logits))
        return self._python_loop(s, first, cache, _stop_ids(eos_token_id, extra_stop_ids or ()),
                                 max_new_tokens, min_new_tokens)

    def _python_loop(self, s: int, tok: int, cache, stops: List[int], max_new_tokens: int,
                     min_new_tokens: int) -> List[int]:
        """The JAX device loop's semantics, one decode a step on the host:
        emit ``tok``, decode it at slot s + t, take the argmax; stop before a
        stop token once ``min_new_tokens`` are out, or after
        ``max_new_tokens``. The last emitted token is not decoded: the JAX
        loop discards that step's logits."""
        out: List[int] = []
        done = tok in stops and min_new_tokens <= 0
        while not done and len(out) < max_new_tokens:
            out.append(tok)
            if len(out) == max_new_tokens:
                break
            step = torch.tensor([tok], dtype=torch.long, device=self.device)
            tok = int(torch.argmax(self._decode(step, cache, s + len(out) - 1)[0]))
            done = tok in stops and len(out) >= min_new_tokens
        return out

    @torch.no_grad()
    def greedy_batch(self, prompts: List[np.ndarray], max_new_tokens: int,
                     eos_token_id: Optional[int] = None, min_new_tokens: int = 0,
                     pad_token_id: int = 0) -> List[List[int]]:
        """Batched greedy generation over prompts of different lengths.

        Prompts are LEFT-padded to a common multiple of 128, so every row's
        last real token sits in the same slot; each row's RoPE positions start
        at 0 at its first real token, and its pad slots are masked out of
        attention. Row b's generated token t sits in slot s_pad + t at
        position len_b + t. A row stops at its own stop token."""
        b = len(prompts)
        rows = [np.asarray(p).reshape(-1) for p in prompts]
        lens = [len(r) for r in rows]
        s_pad = _round_up(max(lens), _PREFILL_BUCKET)
        cache_len = _round_up(s_pad + max_new_tokens, _PREFILL_BUCKET)

        padded = torch.full((b, s_pad), pad_token_id, dtype=torch.long)
        positions = torch.zeros((b, s_pad), dtype=torch.long)
        length_mask = torch.zeros((b, cache_len), dtype=torch.int32)
        length_mask[:, s_pad:] = 1  # generated slots (causality guards the future)
        for i, (ids, n) in enumerate(zip(rows, lens)):
            padded[i, s_pad - n:] = torch.as_tensor(ids, dtype=torch.long)
            positions[i, s_pad - n:] = torch.arange(n)
            length_mask[i, s_pad - n: s_pad] = 1
        dev = self.device
        length_mask = length_mask.to(dev)
        cache = init_kv_cache(self.config, b, cache_len, device=dev, quantized=self.quantized_kv,
                              mesh=self.mesh)
        logits, cache = prefill(self.params, padded.to(dev), cache, config=self.config,
                                plan=self.plan, length_mask=length_mask,
                                positions=positions.to(dev), mesh=self.mesh)
        toks = torch.argmax(logits[:, s_pad - 1], dim=-1)

        stops = torch.tensor(_stop_ids(eos_token_id), dtype=torch.long, device=dev)
        lens_t = torch.tensor(lens, dtype=torch.long, device=dev)

        def is_stop(t: torch.Tensor, n_emitted: int) -> torch.Tensor:
            return (t[:, None] == stops[None, :]).any(dim=1) & (n_emitted >= min_new_tokens)

        out = torch.full((b, max_new_tokens), -1, dtype=torch.long, device=dev)
        done = is_stop(toks, 0)
        for t in range(max_new_tokens):
            if bool(done.all()):
                break
            out[:, t] = torch.where(done, -1, toks)
            if t + 1 == max_new_tokens:
                break
            toks = torch.argmax(self._decode(toks, cache, s_pad + t, length_mask=length_mask,
                                             positions=(lens_t + t)[:, None]), dim=-1)
            done = done | is_stop(toks, t + 1)
        results = []
        for row in out.cpu().tolist():
            results.append(row[: row.index(-1)] if -1 in row else row)
        return results


def topk_topp_filter(scaled: torch.Tensor, ks: torch.Tensor, top_ps: torch.Tensor,
                     max_k: int, min_ps: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Batched HF-semantics top-k / nucleus / min-p filter, the one filter of
    :func:`filter_logits` and the paged engine's per-request sampler.

    scaled: [B, V] temperature-scaled logits. ks: [B] per-row k (0 = no
    top-k; at most max_k). top_ps: [B] nucleus threshold: keep the smallest
    prefix of the descending-prob distribution covering top_p, always at least
    one token. min_ps (optional, [B], 0 = off): drop tokens below min_p times
    the top probability. Filtered entries become the fp32 minimum."""
    neg = torch.finfo(torch.float32).min
    scaled = scaled.float()
    vals = torch.topk(scaled, max_k, dim=-1).values  # [B, max_k] descending
    kth = vals.gather(1, (ks[:, None].long() - 1).clamp(0, max_k - 1))
    filt = torch.where((ks[:, None] > 0) & (scaled < kth), neg, scaled)
    # nucleus: drop tokens whose preceding cumulative mass already covers top_p
    sorted_l, order = torch.sort(filt, dim=-1, descending=True, stable=True)
    probs = torch.softmax(sorted_l, dim=-1)
    drop_sorted = (torch.cumsum(probs, dim=-1) - probs) >= top_ps[:, None]
    drop = torch.empty_like(drop_sorted).scatter_(1, order, drop_sorted)
    out = torch.where(drop, neg, filt)
    if min_ps is not None:
        p = torch.softmax(out, dim=-1)
        low = p < min_ps[:, None] * p.max(dim=-1, keepdim=True).values
        keep_top = out >= out.max(dim=-1, keepdim=True).values
        out = torch.where(low & ~keep_top & (min_ps[:, None] > 0), neg, out)
    return out


def filter_logits(logits: torch.Tensor, top_k: int, top_p=1.0, min_p=0.0) -> torch.Tensor:
    """Top-k / nucleus (top-p) / min-p filtering of [B, V] logits with HF
    semantics; ``top_k`` 0 (or >= V) and ``min_p`` 0 are off. A serving-side
    extension: the reference decodes greedily."""
    b, v = logits.shape
    active = 0 < top_k < v
    dev = logits.device
    ks = torch.full((b,), top_k if active else 0, dtype=torch.int32, device=dev)
    tps = torch.as_tensor(top_p, dtype=torch.float32, device=dev).broadcast_to((b,))
    mps = torch.as_tensor(min_p, dtype=torch.float32, device=dev).broadcast_to((b,))
    return topk_topp_filter(logits, ks, tps, max_k=top_k if active else 1, min_ps=mps)


class SamplingGenerator(Generator):
    """Temperature / top-k / nucleus / min-p sampling from one prompt, with a
    ``torch.Generator`` seeded from ``seed`` on the model's device; the same
    seed gives the same stream. Temperature 0 or top_k 1 is exact greedy. The
    stream is not the JAX package's (another random generator); it follows
    the same distribution."""

    @torch.no_grad()
    def sample(self, prompt_ids: np.ndarray, max_new_tokens: int, temperature: float = 1.0,
               top_k: int = 0, top_p: float = 1.0, seed: int = 0,
               eos_token_id: Optional[int] = None, min_p: float = 0.0) -> List[int]:
        """Sample a continuation; the new ids. A stop token ends it unemitted."""
        s, _, logits, cache = self._prefill_one(prompt_ids, max_new_tokens)
        greedy = temperature == 0.0 or top_k == 1
        gen = torch.Generator(device=self.device).manual_seed(seed)
        temp = max(temperature, 1e-6)

        def pick(step_logits: torch.Tensor) -> int:
            if greedy:
                return int(torch.argmax(step_logits))
            filt = filter_logits(step_logits.float()[None] / temp, top_k, top_p, min_p)
            return int(torch.multinomial(torch.softmax(filt, dim=-1), 1, generator=gen)[0, 0])

        stops = _stop_ids(eos_token_id)
        out: List[int] = []
        tok = pick(logits)
        while tok not in stops and len(out) < max_new_tokens:
            out.append(tok)
            if len(out) == max_new_tokens:
                break
            step = torch.tensor([tok], dtype=torch.long, device=self.device)
            tok = pick(self._decode(step, cache, s + len(out) - 1)[0])
        return out


def greedy_generate(params: Params, config: ModelConfig, prompt_ids: np.ndarray,
                    max_new_tokens: int, plan: Optional[ModelPlan] = None,
                    eos_token_id: Optional[int] = None) -> List[int]:
    """One-shot convenience wrapper around :class:`Generator`."""
    return Generator(params, config, plan).greedy(prompt_ids, max_new_tokens, eos_token_id)
