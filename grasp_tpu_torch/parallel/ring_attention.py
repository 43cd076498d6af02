"""Ring attention: context parallelism over one mesh axis (counterpart of
grasp_tpu/parallel/ring_attention.py).

The sequence is split over an axis of the mesh: each rank holds one
contiguous block of Q, K and V. The K/V blocks rotate around the ring with
:func:`parallel.mesh.ppermute` while an online softmax accumulates, so each
rank attends over the whole sequence with O(S/n) activations. Causality,
sliding windows and Gemma-2's softcap come from absolute positions: at step
i a rank holds the block of position ``(idx - i) mod n``.

The block step is two products and the online softmax, as in JAX, where it
is two einsums outside any Pallas kernel: scores in fp32, masked with
:data:`MASK_VALUE`, ``p`` cast to V's dtype before the PV product (fp32
accumulation), and ``1 / l`` taken as 1 where a row saw no key. Unlike JAX,
which rotates K/V after the GQA repeat, the ring here rotates the KV heads
themselves and repeats them after each receive: the same numbers, 1/groups
of the traffic. The gradient rides the ring backwards (the ppermute's
inverse permutation).
"""

from __future__ import annotations

import math
from typing import Optional

import numpy as np
import torch

from grasp_tpu_torch.parallel.mesh import DATA_AXIS, Mesh, ppermute

MASK_VALUE = -0.7 * float(np.finfo(np.float32).max)


def ring_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, mesh: Mesh,
                   axis_name: str = DATA_AXIS, causal: bool = True,
                   sm_scale: Optional[float] = None, window: Optional[int] = None,
                   softcap: Optional[float] = None, num_kv_groups: int = 1) -> torch.Tensor:
    """Attention over a sequence split on ``axis_name`` (this rank's blocks).

    q [B, H, S_local, D]; k, v [B, H / num_kv_groups, S_local, D]; the rank
    at position i of the axis holds sequence block i. Returns this rank's
    output block [B, H, S_local, D] in q's dtype. ``window``: query p sees
    keys (p - window, p]; ``softcap``: c * tanh(s / c) after the scale and
    before the mask (HF's order)."""
    n = mesh.shape[axis_name]
    idx = mesh.axis_index(axis_name)
    s_local, d = q.shape[2], q.shape[3]
    scale = sm_scale if sm_scale is not None else 1.0 / math.sqrt(d)
    dev = q.device
    q_pos = idx * s_local + torch.arange(s_local, device=dev)
    perm = [(j, (j + 1) % n) for j in range(n)]
    qf = q.float()

    m = l = acc = None
    kv = torch.stack([k, v])
    for i in range(n):
        if i:
            kv = ppermute(kv, mesh, axis_name, perm)
        k_cur, v_cur = kv[0], kv[1]
        if num_kv_groups > 1:
            k_cur = k_cur.repeat_interleave(num_kv_groups, dim=1)
            v_cur = v_cur.repeat_interleave(num_kv_groups, dim=1)
        src = (idx - i) % n  # whose block this rank holds now
        kv_pos = src * s_local + torch.arange(s_local, device=dev)

        s = torch.matmul(qf, k_cur.float().transpose(-1, -2)) * scale
        if softcap is not None:
            s = softcap * torch.tanh(s / softcap)
        if causal or window is not None:
            allow = (kv_pos[None, :] <= q_pos[:, None] if causal
                     else torch.ones(s_local, s_local, dtype=torch.bool, device=dev))
            if window is not None:
                allow = allow & (kv_pos[None, :] > q_pos[:, None] - window)
            s = torch.where(allow, s, MASK_VALUE)

        m_curr = s.amax(dim=-1, keepdim=True)
        m_next = m_curr if m is None else torch.maximum(m, m_curr)
        p = torch.exp(s - m_next)
        pv = torch.matmul(p.to(v_cur.dtype).float(), v_cur.float())
        if m is None:
            l, acc = p.sum(dim=-1, keepdim=True), pv
        else:
            alpha = torch.exp(m - m_next)
            l = alpha * l + p.sum(dim=-1, keepdim=True)
            acc = acc * alpha + pv
        m = m_next
    l_inv = torch.where(l == 0.0, torch.ones_like(l), 1.0 / l)
    return (acc * l_inv).to(q.dtype)


def context_parallel_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, mesh: Mesh,
                               axis: str = DATA_AXIS, causal: bool = True,
                               num_kv_groups: int = 1, window: Optional[int] = None,
                               softcap: Optional[float] = None) -> torch.Tensor:
    """Full-sequence attention with the sequence split over ``axis``: q [B,
    nh, S, hd] and k/v [B, nkv, S, hd] whole on every rank (S divides by the
    axis size); each rank attends with its block of queries through the ring,
    and the blocks are assembled, whole on every rank."""
    from grasp_tpu_torch.parallel.mesh import axis_gather

    n, idx = mesh.shape[axis], mesh.axis_index(axis)
    s = q.shape[2]
    if s % n:
        raise ValueError(f"a sequence of {s} does not divide over {n} ranks of {axis!r}")
    blk = slice(idx * (s // n), (idx + 1) * (s // n))
    out = ring_attention(q[:, :, blk], k[:, :, blk], v[:, :, blk], mesh, axis, causal=causal,
                         window=window, softcap=softcap, num_kv_groups=num_kv_groups)
    return axis_gather(out, 2, mesh, axis)
