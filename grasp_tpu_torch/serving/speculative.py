"""Speculative decoding over the dense KV cache (counterpart of
grasp_tpu/serving/speculative.py): draft with a cheaper model, verify with
the target in one multi-token forward.

Greedy acceptance rule: draft token i is accepted iff it equals the target's
argmax at that position; the first mismatch is replaced by the target's argmax
and the rest of the chunk is discarded. The emitted stream is therefore the
target's own greedy stream: speculation changes the time a token takes, never
the token. Sampled requests take the rejection rule of Leviathan et al.
(:func:`speculative_accept`), which emits the target's distribution exactly.

Rejected positions leave stale KV in both caches. That is safe: the causal
mask over absolute positions (models/llama.py ``_forward_with_cache``) hides
slots beyond each query's position, and the next chunk overwrites them.

The JAX package runs a whole generation as one jitted ``lax.while_loop``,
because each dispatch there cost tens of milliseconds. Here the loop is a host
loop over ``decode_step`` and ``_forward_with_cache``; ``last_stats`` keeps
the same keys. Random draws come from one ``torch.Generator`` seeded with the
request's seed, so sampled streams differ from the JAX package's in their bits
and agree in distribution.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from grasp_tpu_torch.configs import ModelConfig
from grasp_tpu_torch.eval.generate import topk_topp_filter
from grasp_tpu_torch.models.llama import (
    ModelPlan,
    Params,
    _forward_with_cache,
    decode_step,
    default_plan,
    init_kv_cache,
    prefill,
)

_BUCKET = 128


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


def speculative_accept(generator: torch.Generator, drafts: torch.Tensor, q_probs: torch.Tensor,
                       p_probs: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """The rejection step of speculative sampling for one chunk: the math
    that makes the emitted stream follow the target distribution exactly.

    drafts: [gamma] draft tokens, d_i drawn from q_probs[i] ([gamma, V]).
    p_probs: [gamma + 1, V] target distributions at each position. Draft i is
    accepted with probability min(1, p_i(d_i) / q_i(d_i)); at the first
    rejection the replacement is drawn from norm((p_i - q_i)+); if all gamma
    are accepted a bonus token is drawn from p_gamma. Returns (a, token) as
    0-d tensors on the inputs' device: the number of accepted drafts and the
    correction or bonus token. Draws gamma uniforms and one token from
    ``generator`` (on the tensors' device); nothing syncs with the host."""
    gamma = drafts.shape[0]
    idx = torch.arange(gamma, device=drafts.device)
    p_d = p_probs[idx, drafts]
    q_d = q_probs[idx, drafts]
    u = torch.rand(gamma, generator=generator, device=drafts.device)
    # strict <: differs from u <= p/q only on events of measure zero for
    # p > 0, and a draw of u == 0 cannot accept a draft the target gives
    # probability 0 (outside its filtered support)
    ok = u * q_d < p_d
    a = torch.cumprod(ok.to(torch.int64), dim=0).sum()

    # residual distribution at the rejection point (row a, clamped for a = gamma)
    j = torch.clamp(a, max=gamma - 1)
    resid = torch.clamp(p_probs[j] - q_probs[j], min=0.0)
    z = resid.sum()
    resid = torch.where(z > 0, resid / torch.clamp(z, min=1e-30), p_probs[j])
    final = torch.where(a == gamma, p_probs[gamma], resid)
    tok = torch.multinomial(final, 1, generator=generator)[0]
    return a, tok


def _filtered(logits: torch.Tensor, temperature: float, top_k: int, top_p: float) -> torch.Tensor:
    """Temperature, top-k and nucleus filter of [N, V] logits (fp32)."""
    n = logits.shape[0]
    dev = logits.device
    return topk_topp_filter(logits.float() / temperature,
                            torch.full((n,), top_k, dtype=torch.long, device=dev),
                            torch.full((n,), top_p, dtype=torch.float32, device=dev),
                            max(top_k, 1))


class SpeculativeGenerator:
    """Speculative decoding with a draft and a target model over dense caches.

    The two may have different configs and plans (a GRASP-compressed draft of
    the same family, say) but must share the vocabulary. ``quantized_kv``:
    both caches are int8 (``init_kv_cache(quantized=True)``). ``mesh``: both
    models' params tensor-parallel on it (parallel.mesh.shard_params)."""

    def __init__(self, target_params: Params, target_config: ModelConfig,
                 draft_params: Params, draft_config: ModelConfig,
                 target_plan: Optional[ModelPlan] = None,
                 draft_plan: Optional[ModelPlan] = None, gamma: int = 4,
                 quantized_kv: bool = False, *, device, mesh=None):
        if target_config.vocab_size != draft_config.vocab_size:
            raise ValueError("draft and target must share a vocabulary")
        self.tparams, self.tconfig = target_params, target_config
        self.dparams, self.dconfig = draft_params, draft_config
        self.tplan = target_plan or default_plan(target_config)
        self.dplan = draft_plan or default_plan(draft_config)
        self.gamma = int(gamma)
        self.quantized_kv = quantized_kv
        self.device = torch.device(device)
        self.mesh = mesh
        self.last_stats: Dict[str, float] = {}

    # ------------------------------------------------------------------
    def _prefill_both(self, prompt_ids, max_new_tokens: int):
        """Both caches prefilled with the prompt (padded to a bucket).
        Returns (target logits at the last prompt position, tcache, dcache,
        prompt length)."""
        ids = np.asarray(prompt_ids).reshape(1, -1).astype(np.int64)
        s = ids.shape[1]
        s_pad = _round_up(max(s, 1), _BUCKET)
        cache_len = _round_up(s + max_new_tokens + self.gamma + 1, _BUCKET)
        padded = np.zeros((1, s_pad), np.int64)
        padded[0, :s] = ids[0]
        tp = torch.from_numpy(padded).to(self.device)
        tcache = init_kv_cache(self.tconfig, 1, cache_len, device=self.device,
                               quantized=self.quantized_kv, mesh=self.mesh)
        dcache = init_kv_cache(self.dconfig, 1, cache_len, device=self.device,
                               quantized=self.quantized_kv, mesh=self.mesh)
        tlogits, tcache = prefill(self.tparams, tp, tcache, config=self.tconfig, plan=self.tplan,
                                  mesh=self.mesh)
        _, dcache = prefill(self.dparams, tp, dcache, config=self.dconfig, plan=self.dplan,
                            mesh=self.mesh)
        return tlogits[0, s - 1], tcache, dcache, s

    def _loop(self, first_tok: int, tcache, dcache, start_pos: int, max_new: int,
              eos_token_id: Optional[int], pick_draft, accept) -> List[int]:
        """The chunk loop shared by greedy and sampled decoding.

        pick_draft(logits [V]) -> (next token 0-d tensor, q_i or None);
        accept(drafts [gamma], q [gamma, V] or None, tlogits [gamma + 1, V])
        -> (a, token the chunk ends with), Python ints."""
        gamma, dev = self.gamma, self.device
        out = np.full(max_new + gamma + 1, -1, np.int64)  # a chunk may overshoot
        out[0] = first_tok
        n, pos, tok = 1, start_pos, first_tok
        done = eos_token_id is not None and first_tok == eos_token_id
        chunks = acc = 0
        while not done and n < max_new:
            # draft phase: gamma + 1 single-token steps. The extra step writes
            # d_gamma's KV into the draft cache (needed when the whole chunk is
            # accepted: the next chunk resumes at pos + gamma + 1 and must see
            # d_gamma at pos + gamma); its logits are dropped.
            dtok = torch.tensor([[tok]], device=dev)
            drafts, qs = [], []
            for i in range(gamma + 1):
                logits, dcache = decode_step(self.dparams, dtok, dcache, pos + i,
                                             config=self.dconfig, plan=self.dplan,
                                             mesh=self.mesh)
                if i == gamma:
                    break
                nxt, q_i = pick_draft(logits[0, 0])
                drafts.append(nxt)
                qs.append(q_i)
                dtok = nxt.reshape(1, 1)
            drafts_t = torch.stack(drafts)

            # target verify: one (gamma + 1)-token forward
            verify_in = torch.cat([torch.tensor([tok], device=dev), drafts_t])[None, :]
            tlogits, tcache = _forward_with_cache(self.tparams, verify_in, tcache, pos,
                                                  config=self.tconfig, plan=self.tplan,
                                                  mesh=self.mesh)
            a, last = accept(drafts_t, None if qs[0] is None else torch.stack(qs), tlogits[0])

            # emitted chunk: d_1..d_a, then the correction (or bonus) token
            chunk = drafts_t[:a].tolist() + [last] * (gamma + 1 - a)
            stop_pos = next((i for i, t in enumerate(chunk) if t == eos_token_id), gamma + 1)
            emit = min(a + 1, stop_pos, max_new - n)
            out[n:n + gamma + 1] = chunk
            n, pos, tok = n + emit, pos + a + 1, last
            done = stop_pos <= a or n >= max_new
            chunks += 1
            acc += a

        self.last_stats = {
            "chunks": chunks,
            "drafted": chunks * gamma,
            "accepted": acc,
            "acceptance_rate": acc / max(chunks * gamma, 1),
            "tokens": n,
            # target forwards: one prefill and one verify per chunk; plain
            # greedy decoding would have taken ``n`` decode steps
            "target_calls": chunks,
        }
        # the emitted stream never includes a stop token; a stop inside a
        # chunk capped ``emit`` before it was counted
        toks = out[:n]
        if eos_token_id is not None:
            hit = np.where(toks == eos_token_id)[0]
            if len(hit):
                toks = toks[:hit[0]]
        return toks.tolist()

    # ------------------------------------------------------------------
    @torch.no_grad()
    def greedy(self, prompt_ids, max_new_tokens: int,
               eos_token_id: Optional[int] = None) -> List[int]:
        """Greedy generation, token for token the target's own greedy stream."""
        if max_new_tokens <= 0:
            return []
        first_logits, tcache, dcache, s = self._prefill_both(prompt_ids, max_new_tokens)
        gamma = self.gamma

        def pick_draft(logits):
            return torch.argmax(logits), None

        def accept(drafts, q_probs, tlogits):
            targets = torch.argmax(tlogits, dim=-1)  # [gamma + 1]
            matches = (targets[:gamma] == drafts).to(torch.int64)
            a = int(torch.cumprod(matches, dim=0).sum())  # longest agreeing prefix
            return a, int(targets[a])

        return self._loop(int(torch.argmax(first_logits)), tcache, dcache, s, max_new_tokens,
                          eos_token_id, pick_draft, accept)

    @torch.no_grad()
    def sample(self, prompt_ids, max_new_tokens: int, temperature: float = 1.0,
               top_k: int = 0, top_p: float = 1.0, seed: int = 0,
               eos_token_id: Optional[int] = None) -> List[int]:
        """Speculative sampling: emits tokens distributed exactly as the
        target's own temperature/top-k/top-p sampling would. temperature=0 or
        top_k=1 takes the greedy path."""
        if max_new_tokens <= 0:
            return []
        if temperature == 0.0 or top_k == 1:
            return self.greedy(prompt_ids, max_new_tokens, eos_token_id)
        temperature = max(temperature, 1e-6)
        gen = torch.Generator(device=self.device).manual_seed(int(seed))
        first_logits, tcache, dcache, s = self._prefill_both(prompt_ids, max_new_tokens)
        first_p = torch.softmax(_filtered(first_logits[None], temperature, top_k, top_p)[0], -1)
        first_tok = int(torch.multinomial(first_p, 1, generator=gen)[0])

        def pick_draft(logits):
            q_i = torch.softmax(_filtered(logits[None], temperature, top_k, top_p)[0], dim=-1)
            return torch.multinomial(q_i, 1, generator=gen)[0], q_i

        def accept(drafts, q_probs, tlogits):
            p_probs = torch.softmax(_filtered(tlogits, temperature, top_k, top_p), dim=-1)
            a, corr = speculative_accept(gen, drafts, q_probs, p_probs)
            return int(a), int(corr)

        return self._loop(first_tok, tcache, dcache, s, max_new_tokens, eos_token_id,
                          pick_draft, accept)
