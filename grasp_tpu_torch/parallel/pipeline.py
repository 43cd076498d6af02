"""GPipe pipeline parallelism over a "pipe" mesh axis (counterpart of
grasp_tpu/parallel/pipeline.py).

The layout is JAX's: the layers are stacked to ``[num_stages, depth, ...]``
under ``"stages"`` (:func:`to_pipeline_params` / :func:`from_pipeline_params`),
the embedding, final norm and head beside them; :func:`shard_pipeline_params`
leaves each rank its own stage, ``[1, depth, ...]``, and the rest replicated.

The schedule runs M microbatches through S stages, one process a stage
(a one-axis mesh, ``make_mesh((S,), axis_names=("pipe",))``). Stage 0 embeds
a microbatch (Gemma's scale included), every stage runs its layers
(``models.llama._layer_forward``: plain attention, never the flash kernels,
and the fused low-rank kernel for the low-rank pairs where
``config.use_pallas_lowrank`` holds, as in JAX) and sends the activations
on; the last stage applies the final norm, the head (tied: the embedding's
transpose) and Gemma-2's final softcap and takes the cross-entropy sum and
the label count. The loss is ``sum(ce) / max(n, 1)`` over the pipe group:
``hf_causal_lm_loss`` of the whole batch. Unlike JAX's SPMD program, a stage
computes nothing in the fill and drain bubbles: it waits for its input.

The backward is a hand-written schedule (:meth:`PipelineLoss.value_and_grad`):
for each microbatch in reverse order, the last stage differentiates its
cross entropy, and every other stage receives the gradient of its output,
differentiates its layers and sends the gradient of its input back. Sends
never block, and neighbours post sends and receives in the same order, so the
ranks cannot deadlock. ``remat`` recomputes each layer's forward in the
backward. The replicated embedding, norm and head take their gradients
summed over the pipe group (with tied embeddings the lookup on stage 0 and
the head on the last stage add up).

A heterogeneous GRASP plan (dense and low-rank layers, ranks that differ)
is made uniform by :func:`hybridize_layers`: every slot that mixes kinds
becomes the ``hybrid`` form ``x @ kernel + (x @ in_kernel) @ out_kernel``,
whose unused half and rank padding hold exact zeros; :func:`hybrid_grad_mask`
keeps those zeros through training and :func:`dehybridize_layers` restores
the original tree.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, List, Optional, Tuple

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from grasp_tpu_torch.configs import ModelConfig
from grasp_tpu_torch.models.convert import flatten_params, map_params, unflatten_params
from grasp_tpu_torch.models.llama import (
    ATTN_PROJS,
    DENSE,
    HYBRID,
    LOWRANK,
    PROJ_ORDER,
    LayerPlan,
    ModelPlan,
    Params,
    _causal_mask,
    _layer_forward,
    embed_lookup,
    final_logits,
    hf_causal_lm_loss_sum,
    rope_cos_sin,
    torch_dtype,
)
from grasp_tpu_torch.parallel.mesh import PIPE_AXIS, Mesh

REPLICATED = ("embed_tokens", "norm", "lm_head")


def uniform_layer_plan(plan: ModelPlan) -> LayerPlan:
    """The one LayerPlan that every layer shares; raises if they differ."""
    if any(p != plan[0] for p in plan[1:]):
        raise ValueError(
            "pipeline parallelism requires a uniform per-layer plan "
            f"(got {set(plan)}); compile GRASP models with merge=True or a "
            "uniform-rank low-rank plan")
    return plan[0]


def _proj_group(proj: str) -> str:
    return "self_attn" if proj in ATTN_PROJS else "mlp"


def hybridize_layers(params: Params, plan: ModelPlan):
    """A heterogeneous dense/low-rank plan made structurally uniform, slot
    by slot (q_proj ... down_proj) over all layers: all dense stays dense;
    all low-rank stays low-rank, zero-padded to the largest rank; dense and
    low-rank mixed becomes ``hybrid``, the unused half zeros. The zeros are
    exact, so the forward is the heterogeneous model's.

    Returns (params, the layer plan every layer shares, spec): spec holds
    each (layer, slot)'s original (kind, rank or None)."""
    n = len(plan)
    resolved: List[Tuple[str, Optional[int]]] = []
    for j, proj in enumerate(PROJ_ORDER):
        kinds = {plan[i][j] for i in range(n)}
        if not kinds <= {DENSE, LOWRANK}:
            raise ValueError(f"hybridize_layers supports dense/lowrank plans, got {kinds} "
                             f"for {proj} (compile svd modules first)")
        if kinds == {DENSE}:
            resolved.append((DENSE, None))
            continue
        r = max(params["layers"][i][_proj_group(proj)][proj]["in_kernel"].shape[1]
                for i in range(n) if plan[i][j] == LOWRANK)
        resolved.append((HYBRID if DENSE in kinds else LOWRANK, r))

    spec, new_layers = [], []
    for i, layer in enumerate(params["layers"]):
        new_layer = {k: v for k, v in layer.items() if k not in ("self_attn", "mlp")}
        new_layer["self_attn"] = dict(layer["self_attn"])
        new_layer["mlp"] = dict(layer["mlp"])
        lspec = []
        for j, proj in enumerate(PROJ_ORDER):
            grp = _proj_group(proj)
            mod = layer[grp][proj]
            kind, r = resolved[j]
            if kind == DENSE:
                lspec.append((DENSE, None))
                continue
            if plan[i][j] == LOWRANK:
                in_k, out_k = mod["in_kernel"], mod["out_kernel"]
                r0 = in_k.shape[1]
                lspec.append((LOWRANK, r0))
                if r0 < r:
                    in_k = F.pad(in_k, (0, r - r0))
                    out_k = F.pad(out_k, (0, 0, 0, r - r0))
                new_mod = {"in_kernel": in_k, "out_kernel": out_k}
                if kind == HYBRID:
                    new_mod["kernel"] = in_k.new_zeros((in_k.shape[0], out_k.shape[1]))
            else:  # a dense layer in a hybrid slot
                lspec.append((DENSE, None))
                kern = mod["kernel"]
                new_mod = {"kernel": kern,
                           "in_kernel": kern.new_zeros((kern.shape[0], r)),
                           "out_kernel": kern.new_zeros((r, kern.shape[1]))}
            if "bias" in mod:
                new_mod["bias"] = mod["bias"]
            new_layer[grp][proj] = new_mod
        spec.append(lspec)
        new_layers.append(new_layer)
    return {**params, "layers": new_layers}, tuple(kind for kind, _ in resolved), spec


def dehybridize_layers(params: Params, spec) -> Params:
    """:func:`hybridize_layers`' inverse: the zero halves and the rank
    padding stripped. Takes the params or any tree of their shape (a
    gradient tree)."""
    out_layers = []
    for i, layer in enumerate(params["layers"]):
        new_layer = {k: v for k, v in layer.items() if k not in ("self_attn", "mlp")}
        new_layer["self_attn"] = dict(layer["self_attn"])
        new_layer["mlp"] = dict(layer["mlp"])
        for j, proj in enumerate(PROJ_ORDER):
            grp = _proj_group(proj)
            mod = layer[grp][proj]
            kind, r = spec[i][j]
            if kind == DENSE:
                new_mod = {"kernel": mod["kernel"]}
            else:
                new_mod = {"in_kernel": mod["in_kernel"][:, :r],
                           "out_kernel": mod["out_kernel"][:r, :]}
            if "bias" in mod:
                new_mod["bias"] = mod["bias"]
            new_layer[grp][proj] = new_mod
        out_layers.append(new_layer)
    return {**params, "layers": out_layers}


def hybrid_grad_mask(hparams: Params, spec) -> Params:
    """A 1/0 tree over a hybridized tree: 0 on the structural zeros (unused
    halves, rank padding), 1 on real parameters; ``make_pp_train_step``'s
    ``grad_mask`` multiplies the updates by it, so the zeros stay zero."""
    mask = map_params(hparams, torch.ones_like)
    for i, lspec in enumerate(spec):
        for j, (kind, r) in enumerate(lspec):
            proj = PROJ_ORDER[j]
            grp = _proj_group(proj)
            mod = hparams["layers"][i][grp][proj]
            mmod = mask["layers"][i][grp][proj]
            if kind == DENSE:
                if "in_kernel" in mod:  # a dense layer in a hybrid slot
                    mmod["in_kernel"] = torch.zeros_like(mod["in_kernel"])
                    mmod["out_kernel"] = torch.zeros_like(mod["out_kernel"])
            else:
                if "kernel" in mod:  # a low-rank layer in a hybrid slot
                    mmod["kernel"] = torch.zeros_like(mod["kernel"])
                mmod["in_kernel"][:, r:] = 0
                mmod["out_kernel"][r:, :] = 0
    return mask


def to_pipeline_params(params: Params, num_stages: int) -> Dict[str, Any]:
    """The pipeline layout: the layers stacked to ``[num_stages, depth,
    ...]`` under ``"stages"``; the embedding, norm and head as they are."""
    layers = params["layers"]
    n = len(layers)
    if n % num_stages != 0:
        raise ValueError(f"{n} layers not divisible into {num_stages} stages")
    flats = [flatten_params(layer) for layer in layers]
    if any(f.keys() != flats[0].keys() for f in flats[1:]):
        raise ValueError("pipeline parallelism requires every layer to share one pytree "
                         "structure (uniform plan); see uniform_layer_plan")
    depth = n // num_stages
    stages = {p: torch.stack([f[p] for f in flats]).reshape(num_stages, depth,
                                                            *flats[0][p].shape)
              for p in flats[0]}
    out = {"embed_tokens": params["embed_tokens"], "stages": unflatten_params(stages),
           "norm": params["norm"]}
    if "lm_head" in params:
        out["lm_head"] = params["lm_head"]
    return out


def from_pipeline_params(pparams: Dict[str, Any], num_layers: int) -> Params:
    """:func:`to_pipeline_params`' inverse (checkpoint interop), each layer's
    leaves fresh contiguous tensors."""
    flat = {p: x.reshape(num_layers, *x.shape[2:])
            for p, x in flatten_params(pparams["stages"]).items()}
    layers = [unflatten_params({p: x[i].clone() for p, x in flat.items()})
              for i in range(num_layers)]
    out = {"embed_tokens": pparams["embed_tokens"], "layers": layers, "norm": pparams["norm"]}
    if "lm_head" in pparams:
        out["lm_head"] = pparams["lm_head"]
    return out


def _stages(mesh: Mesh) -> int:
    if PIPE_AXIS not in mesh.shape:
        raise ValueError(f"the pipeline runs on a mesh with a {PIPE_AXIS!r} axis, got {mesh}")
    return mesh.shape[PIPE_AXIS]


def _local(pparams: Dict[str, Any], mesh: Mesh) -> Dict[str, Any]:
    """This rank's view: its stage ``[1, depth, ...]`` (taken from whole
    stacks, ``[num_stages, ...]``), the rest as given."""
    n, idx = _stages(mesh), mesh.axis_index(PIPE_AXIS)

    def stage(x):
        return x if x.shape[0] == 1 else x[idx:idx + 1]

    return {**pparams, "stages": map_params(pparams["stages"], stage)}


def shard_pipeline_params(pparams: Dict[str, Any], mesh: Mesh) -> Dict[str, Any]:
    """This rank's part on its device: its own stage, ``[1, depth, ...]``
    (a copy), and the replicated leaves."""
    local = _local(pparams, mesh)
    return {k: map_params(v, lambda x: x.to(mesh.device).clone() if k == "stages"
                          else x.to(mesh.device))
            for k, v in local.items()}


class PipelineLoss:
    """``loss(pparams, input_ids, labels)`` through the GPipe schedule, and
    :meth:`value_and_grad`. Made by :func:`make_pipeline_loss`."""

    def __init__(self, config: ModelConfig, layer_plan: LayerPlan, mesh: Mesh,
                 num_microbatches: int, remat: bool = False):
        self.config, self.layer_plan, self.mesh = config, tuple(layer_plan), mesh
        self.num_stages, self.M, self.remat = _stages(mesh), num_microbatches, remat
        self.stage = mesh.axis_index(PIPE_AXIS)

    def __call__(self, pparams, input_ids: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
        with torch.no_grad():
            return self._run(_local(pparams, self.mesh), input_ids, labels, grad=False)[0]

    def value_and_grad(self, pparams, input_ids: torch.Tensor,
                       labels: torch.Tensor) -> Tuple[torch.Tensor, Dict[str, Any]]:
        """(loss, gradients): the gradients in the shape of this rank's
        part (its stage ``[1, depth, ...]``; the embedding, norm and head
        whole, summed over the pipe group), as ``jax.value_and_grad`` of
        the JAX loss gives them on this rank's shard."""
        local = map_params(_local(pparams, self.mesh),
                           lambda x: x.detach().requires_grad_())
        with torch.enable_grad():
            loss, records, n = self._run(local, input_ids, labels, grad=True)
            self._backward(records, n)
        grads = {}
        for k, v in local.items():
            grads[k] = map_params(v, lambda x: x.grad if x.grad is not None
                                  else torch.zeros_like(x))
            if k in REPLICATED:
                for g in flatten_params(grads[k]).values():
                    self.mesh.all_reduce(g, PIPE_AXIS)
        return loss.detach(), grads

    # -- the schedule -------------------------------------------------------

    def _stage_fn(self, local, s_len: int, device):
        """h -> this stage's layers applied: each global layer's mask (its
        window), the rotary tables of positions 0..S-1."""
        config = self.config
        depth = next(iter(flatten_params(local["stages"]).values())).shape[1]
        layers = [map_params(local["stages"], lambda x, j=j: x[0, j]) for j in range(depth)]
        first = self.stage * depth
        masks = [_causal_mask(s_len, s_len, 0, device, window=config.layer_window(first + j))
                 for j in range(depth)]
        cos, sin = rope_cos_sin(torch.arange(s_len, device=device)[None, :], config.head_dim_,
                                config.rope_theta, scaling=config.rope_scaling)

        def layer(lp, h, mask):
            return _layer_forward(lp, self.layer_plan, h, cos, sin, mask, config)[0]

        def run(h):
            for lp, mask in zip(layers, masks):
                if self.remat and torch.is_grad_enabled():
                    h = checkpoint(layer, lp, h, mask, use_reentrant=False)
                else:
                    h = layer(lp, h, mask)
            return h

        return run

    def _run(self, local, input_ids, labels, grad: bool):
        config, mesh, M = self.config, self.mesh, self.M
        head = local.get("lm_head")
        if head is not None and "kernel" not in head:
            raise ValueError(
                "pipeline training requires a floating-point lm_head "
                f"(got keys {sorted(head)}); quantized heads (kernel_q/kernel_q4) are a "
                "serving-side format — dequantize before training")
        b, s_len = input_ids.shape
        if b % M != 0:
            raise ValueError(f"batch {b} not divisible into {M} microbatches")
        dev = local["embed_tokens"]["weight"].device
        ids_mb = input_ids.to(dev).reshape(M, b // M, s_len)
        labels_mb = labels.to(dev).reshape(M, b // M, s_len)
        stage_fn = self._stage_fn(local, s_len, dev)
        last = self.stage == self.num_stages - 1
        like = torch.empty((b // M, s_len, config.hidden_size), dtype=torch_dtype(config.dtype),
                           device=dev)
        records, sends = [], []
        ce_sum = torch.zeros((), dtype=torch.float32, device=dev)
        for m in range(M):
            if self.stage == 0:
                h_in = embed_lookup(local, ids_mb[m], config)
            else:
                h_in = mesh.recv(like, PIPE_AXIS, self.stage - 1, tag=m)
                if grad:
                    h_in.requires_grad_()
            h_out = stage_fn(h_in)
            if last:
                h_out = hf_causal_lm_loss_sum(final_logits(h_out, local, config), labels_mb[m])
                ce_sum = ce_sum + h_out.detach()
            else:
                sends.append(mesh.send(h_out, PIPE_AXIS, self.stage + 1, tag=m))
            if grad:
                records.append((h_in, h_out))
        for s in sends:
            s.wait()
        n = torch.clamp((labels_mb[:, :, 1:] != -100).sum(), min=1)
        return mesh.all_reduce(ce_sum, PIPE_AXIS) / n, records, n

    def _backward(self, records, n: torch.Tensor) -> None:
        mesh, M = self.mesh, self.M
        last = self.stage == self.num_stages - 1
        scale = 1.0 / n.float()
        sends = []
        for m in reversed(range(M)):
            h_in, out = records[m]
            if last:
                torch.autograd.backward(out, scale)
            else:
                torch.autograd.backward(out, mesh.recv(out, PIPE_AXIS, self.stage + 1,
                                                       tag=M + m))
            if self.stage > 0:
                sends.append(mesh.send(h_in.grad, PIPE_AXIS, self.stage - 1, tag=M + m))
            records[m] = None
        for s in sends:
            s.wait()


def make_pipeline_loss(config: ModelConfig, layer_plan: LayerPlan, mesh: Mesh,
                       num_microbatches: int, remat: bool = False) -> PipelineLoss:
    """``loss(pparams, input_ids [B, S], labels [B, S])`` through the GPipe
    schedule on the mesh's "pipe" axis (B divides into the microbatches),
    equal to ``hf_causal_lm_loss`` of the whole batch, the same on every
    rank; ``loss.value_and_grad`` gives the gradients too."""
    return PipelineLoss(config, layer_plan, mesh, num_microbatches, remat)


def _pipe_sumsq(mesh: Mesh) -> Callable:
    """The squared global norm of a pipeline gradient dict: each stage's
    leaves summed over the pipe group, the replicated ones once."""

    def sumsq(grads):
        own = [torch.sum(g.float() * g.float()) for p, g in grads.items()
               if p.split(".")[0] == "stages"]
        rep = [torch.sum(g.float() * g.float()) for p, g in grads.items()
               if p.split(".")[0] != "stages"]
        total = torch.stack(own).sum() if own else torch.zeros((), device=mesh.device)
        total = mesh.all_reduce(total.reshape(()).clone(), PIPE_AXIS)
        return total + (torch.stack(rep).sum() if rep else 0.0)

    return sumsq


def make_pp_train_step(config: ModelConfig, layer_plan: LayerPlan, optimizer, mesh: Mesh,
                       num_microbatches: int, remat: bool = False,
                       grad_mask: Optional[Params] = None) -> Callable:
    """``step(pparams, opt_state, input_ids, labels) -> (pparams, opt_state,
    loss)`` on this rank's part of pipeline-layout params. ``optimizer``
    has ``train.recover.Optimizer``'s interface; its state is made by
    ``optimizer.init`` of the same part. A clipping optimizer takes the
    global norm over the whole pipeline. ``grad_mask``: a 1/0 tree in the
    pipeline layout (``to_pipeline_params(hybrid_grad_mask(...))``, whole or
    this rank's part) that multiplies the updates, so the structural zeros
    of a hybridized plan stay exactly zero."""
    from grasp_tpu_torch.train.recover import _leaf_paths, apply_updates

    loss_fn = make_pipeline_loss(config, layer_plan, mesh, num_microbatches, remat)
    if getattr(optimizer, "clip", None) is not None and optimizer.sumsq is None:
        optimizer.sumsq = _pipe_sumsq(mesh)
    mask = None if grad_mask is None else dict(_leaf_paths(_local(grad_mask, mesh)))

    def step(pparams, opt_state, input_ids, labels):
        pparams = _local(pparams, mesh)
        loss, grads = loss_fn.value_and_grad(pparams, input_ids, labels)
        updates, opt_state = optimizer.update(dict(_leaf_paths(grads)), opt_state, pparams)
        if mask is not None:
            updates = {p: u * mask[p].to(u.device, u.dtype) for p, u in updates.items()}
        return apply_updates(pparams, updates), opt_state, loss

    return step
