"""Sequence-parallel forward and training: ring attention through the stack
(counterpart of grasp_tpu/parallel/seq_parallel.py).

The sequence is split over one mesh axis. Each rank embeds its block of S/n
tokens at their absolute positions, runs the position-local parts of every
layer (norms, projections, the MLP) on it, and attends through the ring
(parallel/ring_attention.py). Parameters are replicated: each one enters the
rank's work through ``parallel.mesh.axis_enter``, so that the backward sums
its gradient over the axis, as shard_map's transpose does for ``P()`` inputs.

As in JAX, no kernel runs here: the projections take the plain products
(the fused low-rank flag is not passed) and attention is the ring's block
step. ``remat`` recomputes each layer in the backward
(``torch.utils.checkpoint``). The rotary tables come from each rank's own
positions, so Phi-3's longrope picks its long factors block by block (by the
largest position of the rank's block), as the JAX function does under
shard_map.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import torch
from torch.utils.checkpoint import checkpoint

from grasp_tpu_torch.configs import ModelConfig
from grasp_tpu_torch.models.convert import map_params
from grasp_tpu_torch.models.llama import (
    PROJ_ORDER,
    ModelPlan,
    Params,
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
from grasp_tpu_torch.parallel.mesh import DATA_AXIS, Mesh, axis_enter, axis_gather, axis_sum
from grasp_tpu_torch.parallel.ring_attention import ring_attention


def _local_layer(lp: Params, h: torch.Tensor, layer_plan, cos, sin, config: ModelConfig,
                 mesh: Mesh, axis: str, window: Optional[int]) -> torch.Tensor:
    b, s_local, _ = h.shape
    nh, nkv, hd = config.num_attention_heads, config.num_key_value_heads, config.head_dim_
    kinds = dict(zip(PROJ_ORDER, layer_plan))
    x = norm(h, lp["input_layernorm"]["weight"], config)
    ap = lp["self_attn"]
    q = proj_apply(x, ap["q_proj"], kinds["q_proj"]).reshape(b, s_local, nh, hd).transpose(1, 2)
    k = proj_apply(x, ap["k_proj"], kinds["k_proj"]).reshape(b, s_local, nkv, hd).transpose(1, 2)
    v = proj_apply(x, ap["v_proj"], kinds["v_proj"]).reshape(b, s_local, nkv, hd).transpose(1, 2)
    q, k = apply_rope(q, k, cos, sin)
    attn = ring_attention(q, k, v, mesh, axis, sm_scale=attention_scale(config), window=window,
                          softcap=config.attn_logit_softcapping, num_kv_groups=nh // nkv)
    attn = attn.transpose(1, 2).reshape(b, s_local, nh * hd)
    attn = proj_apply(attn, ap["o_proj"], kinds["o_proj"])
    return attn_mlp_residual(h, attn, lp, kinds, config)


def _block(mesh: Mesh, axis: str, s: int) -> slice:
    n = mesh.shape[axis]
    if s % n:
        raise ValueError(f"a sequence of {s} does not divide over {n} ranks of {axis!r}")
    sl = s // n
    idx = mesh.axis_index(axis)
    return slice(idx * sl, (idx + 1) * sl)


def _local_logits(params: Params, input_ids: torch.Tensor, mesh: Mesh, config: ModelConfig,
                  plan: Optional[ModelPlan], axis: str, remat: bool) -> torch.Tensor:
    """This rank's block of the logits [B, S/n, V]."""
    plan = plan or default_plan(config)
    # the plain products on every path, as JAX's sequence-parallel layer
    config = dataclasses.replace(config, use_pallas_lowrank=False)
    params = map_params(params, lambda t: axis_enter(t, mesh, axis))
    b, s = input_ids.shape
    blk = _block(mesh, axis, s)
    ids = input_ids[:, blk]
    positions = torch.arange(blk.start, blk.stop, device=ids.device)[None, :].expand(b, -1)
    cos, sin = rope_cos_sin(positions, config.head_dim_, config.rope_theta,
                            scaling=config.rope_scaling)
    h = embed_lookup(params, ids, config)
    checkpointed = remat and torch.is_grad_enabled()
    for li in range(config.num_hidden_layers):
        args = (params["layers"][li], h, plan[li], cos, sin, config, mesh, axis,
                config.layer_window(li))
        h = (checkpoint(_local_layer, *args, use_reentrant=False) if checkpointed
             else _local_layer(*args))
    return final_logits(h, params, config)


def seq_parallel_logits(params: Params, input_ids: torch.Tensor, mesh: Mesh,
                        config: ModelConfig, plan: Optional[ModelPlan] = None,
                        axis: str = DATA_AXIS, remat: bool = False) -> torch.Tensor:
    """Logits [B, S, V], whole on every rank, of ``input_ids`` [B, S] (whole
    on every rank) with the sequence split over ``axis`` (S divides by the
    axis size)."""
    return axis_gather(_local_logits(params, input_ids, mesh, config, plan, axis, remat), 1,
                       mesh, axis)


def seq_parallel_loss(params: Params, input_ids: torch.Tensor, labels: torch.Tensor,
                      mesh: Mesh, config: ModelConfig, plan: Optional[ModelPlan] = None,
                      axis: str = DATA_AXIS, remat: bool = False) -> torch.Tensor:
    """HF CausalLM loss (``models.llama.hf_causal_lm_loss``) with the
    sequence split over ``axis``: each rank takes the cross entropy of its
    positions against the next labels (the last position of the sequence
    has none), the sums add over the axis and divide by the count of valid
    shifted labels. The same value on every rank; differentiable, the
    gradients of the replicated params summed over the axis."""
    logits = _local_logits(params, input_ids, mesh, config, plan, axis, remat)
    blk = _block(mesh, axis, input_ids.shape[1])
    target = labels[:, blk.start + 1:blk.stop + 1]
    valid = target != -100
    logp = torch.log_softmax(logits[:, :target.shape[1]].float(), dim=-1)
    nll = -torch.gather(logp, -1, torch.where(valid, target, 0)[..., None])[..., 0]
    total = axis_sum(torch.where(valid, nll, 0.0).sum(), mesh, axis)
    return total / torch.clamp((labels[:, 1:] != -100).sum(), min=1)


def make_seq_parallel_train_step(config: ModelConfig, plan: ModelPlan, optimizer, mesh: Mesh,
                                 axis: str = DATA_AXIS, remat: bool = False) -> Callable:
    """One long-context step with ring attention in the backward:
    ``step(params, opt_state, input_ids, labels) -> (params, opt_state,
    loss)``. ``optimizer`` has ``train.recover.Optimizer``'s interface
    (``init``, ``update``, ``paths``); the gradients are whole on every
    rank, so every rank takes the same step."""
    from grasp_tpu_torch.train.recover import _value_and_grad, apply_updates

    def step(params, opt_state, input_ids, labels):
        loss, grads = _value_and_grad(
            lambda tree: seq_parallel_loss(tree, input_ids, labels, mesh, config, plan, axis,
                                           remat),
            params, optimizer.paths(params))
        updates, opt_state = optimizer.update(grads, opt_state, params)
        return apply_updates(params, updates), opt_state, loss

    return step
