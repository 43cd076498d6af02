"""Plain PyTorch reference of the served models: a LLaMA-family decoder
(Mistral-7B and Phi-3-mini layouts) with GRASP low-rank projections, in fp32.

A frozen copy of the layer equations, independent of the program under test:
it imports only torch and reads the benchmark's own weights
(``harness.weights``: ``[in, out]`` matrices, bf16 as served, widened to fp32
here one layer at a time).

- RMSNorm: x * rsqrt(mean(x^2) + eps) * w.
- RoPE (the HF convention: the rotation pairs dimension i with i + hd / 2),
  theta from the configuration, positions 0.. of the sequence.
- Attention: GQA or MHA (each KV head serves nh / nkv query heads), scores
  scaled by hd ** -0.5, causal, and with a sliding window query i sees keys
  (i - w, i]; softmax in fp32.
- MLP: SwiGLU, down(silu(gate(x)) * up(x)).
- A projection is x @ W, or a GRASP pair (x @ A) @ B.

``precision="bf16"`` rounds each product's activation operand and result to
bf16 (the weights are bf16 already): a witness at the program's precision,
for calibration only.

``precision="fp8"`` is the control: the same equations with both operands of
every projection and of the lm head rounded to float8 e4m3 (the weight scaled
per output column, the activation per row, each by its absmax over 448), then
multiplied in fp32. It stands for serving in the next precision below bf16.

TF32 is switched off (:func:`plain_fp32`) before anything runs on a GPU.
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional, Sequence

import torch

FP8_MAX = 448.0


def plain_fp32() -> None:
    """fp32 products without TF32 on the tensor cores."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def _fp8(x: torch.Tensor, dim: int) -> torch.Tensor:
    """x rounded to float8 e4m3 with one absmax scale along ``dim``."""
    scale = x.abs().amax(dim=dim, keepdim=True).clamp_min(1e-12) / FP8_MAX
    return (x / scale).to(torch.float8_e4m3fn).float() * scale


def _matmul(x: torch.Tensor, w: torch.Tensor, precision: str) -> torch.Tensor:
    w = w.float()
    if precision == "fp8":
        return _fp8(x, -1) @ _fp8(w, 0)
    if precision == "bf16":
        return (x.bfloat16().float() @ w).bfloat16().float()
    return x @ w


def _round(x: torch.Tensor, precision: str) -> torch.Tensor:
    """The witness's activations are held in bf16 between operations."""
    return x.bfloat16().float() if precision == "bf16" else x


def rms_norm(x: torch.Tensor, w: torch.Tensor, eps: float) -> torch.Tensor:
    return x * torch.rsqrt((x * x).mean(-1, keepdim=True) + eps) * w.float()


def rope(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """x: [heads, S, hd]."""
    hd = x.shape[-1]
    inv = 1.0 / theta ** (torch.arange(0, hd, 2, device=x.device, dtype=torch.float32) / hd)
    ang = positions.float()[:, None] * inv[None, :]
    cos = torch.cat([ang.cos(), ang.cos()], -1)
    sin = torch.cat([ang.sin(), ang.sin()], -1)
    half = hd // 2
    rot = torch.cat([-x[..., half:], x[..., :half]], -1)
    return x * cos + rot * sin


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              window: Optional[int]) -> torch.Tensor:
    """q [nh, S, hd], k/v [nkv, S, hd] -> [S, nh * hd]."""
    nh, s, hd = q.shape
    group = nh // k.shape[0]
    k = k.repeat_interleave(group, 0)
    v = v.repeat_interleave(group, 0)
    scores = (q @ k.transpose(1, 2)) / math.sqrt(hd)
    i = torch.arange(s, device=q.device)[:, None]
    j = torch.arange(s, device=q.device)[None, :]
    allow = j <= i
    if window is not None:
        allow = allow & (j > i - window)
    scores = scores.masked_fill(~allow, float("-inf"))
    out = torch.softmax(scores, -1) @ v
    return out.transpose(0, 1).reshape(s, nh * hd)


def project(x: torch.Tensor, w: Dict[str, torch.Tensor], name: str,
            precision: str) -> torch.Tensor:
    """A projection by name: ``name`` is a dense [in, out] matrix, or
    ``name.a`` [in, r] and ``name.b`` [r, out] a GRASP pair."""
    if name in w:
        return _matmul(x, w[name], precision)
    return _matmul(_matmul(x, w[name + ".a"], precision), w[name + ".b"], precision)


def logits_at(w: Dict[str, torch.Tensor], cfg: dict, ids: Sequence[int],
              positions: Sequence[int], precision: str = "fp32") -> torch.Tensor:
    """fp32 logits [len(positions), V] of the sequence ``ids`` at
    ``positions``, each predicting the token after it. ``cfg``: the keys of
    the configuration file (hidden_size, num_attention_heads,
    num_key_value_heads, num_hidden_layers, rope_theta, rms_norm_eps,
    sliding_window)."""
    dev = w["embed"].device
    nh, nkv = cfg["num_attention_heads"], cfg["num_key_value_heads"]
    hd = cfg.get("head_dim") or cfg["hidden_size"] // nh
    eps, theta = cfg["rms_norm_eps"], cfg["rope_theta"]
    ids_t = torch.as_tensor(list(ids), dtype=torch.long, device=dev)
    s = ids_t.shape[0]
    pos = torch.arange(s, device=dev)
    h = w["embed"][ids_t].float()
    def r(x):
        return _round(x, precision)

    for i in range(cfg["num_hidden_layers"]):
        p = f"{i}."
        x = r(rms_norm(h, w[p + "in_norm"], eps))
        q = project(x, w, p + "q", precision).reshape(s, nh, hd).transpose(0, 1)
        k = project(x, w, p + "k", precision).reshape(s, nkv, hd).transpose(0, 1)
        v = project(x, w, p + "v", precision).reshape(s, nkv, hd).transpose(0, 1)
        a = attention(r(rope(q, pos, theta)), r(rope(k, pos, theta)), v,
                      cfg.get("sliding_window"))
        h = r(h + project(r(a), w, p + "o", precision))
        x = r(rms_norm(h, w[p + "post_norm"], eps))
        act = r(torch.nn.functional.silu(project(x, w, p + "gate", precision)))
        h = r(h + project(r(act * project(x, w, p + "up", precision)), w, p + "down",
                          precision))
    idx = torch.as_tensor(list(positions), dtype=torch.long, device=dev)
    x = r(rms_norm(h[idx], w["norm"], eps))
    return _matmul(x, w["lm_head"], precision)


def served_gaps(w: Dict[str, torch.Tensor], cfg: dict, prompt: Sequence[int],
                served: Sequence[int], precision: str = "fp32") -> List[float]:
    """For each served token, how far its fp32 reference logit lies below the
    reference's best at that position. With another ``precision`` the
    tokens judged are that computation's own first picks at the same
    positions (the served tokens still feed the sequence)."""
    ids = list(prompt) + list(served[:-1])
    positions = list(range(len(prompt) - 1, len(prompt) - 1 + len(served)))
    ref = logits_at(w, cfg, ids, positions)
    picks = torch.as_tensor(list(served), dtype=torch.long, device=ref.device)
    if precision != "fp32":
        picks = logits_at(w, cfg, ids, positions, precision).argmax(-1)
    gaps = ref.max(-1).values - ref.gather(1, picks[:, None])[:, 0]
    return gaps.tolist()
