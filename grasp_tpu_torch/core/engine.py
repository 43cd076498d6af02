"""The GRASP compression engine (counterpart of grasp_tpu/core/engine.py).

The engine owns a params dict plus the static per-projection plan (see
grasp_tpu_torch.models.llama) and runs the stages of the JAX engine eagerly:

  - :meth:`compute_bi`             block-influence layer scoring, one forward
                                   per calibration batch
  - :meth:`compress_block`         swap dense kernels for full-SVD factors
  - :meth:`get_svdlayer_gradients` dL/dS of every SVD module, summed over batches
  - :meth:`get_dense_gradients`    dL/d(kernel) of named dense projections
  - :meth:`compress_round`         one (layer, block) round on the dense-gradient
                                   path: SVD, gradient sweep, select, compile
  - :meth:`dynamic_svd_selection`  saliency + top-k or adaptive rank selection
  - :meth:`compile_grasp_model`    truncate + fuse into low-rank or merged dense
  - :meth:`run`                    the whole pipeline: sequential rounds or one
                                   parallel sweep (in chunks of layers), the
                                   prefix split, resume snapshots

Gradients come from autograd over leaf copies of the trainable tensors; every
other parameter is frozen, so the backward pass stops below the lowest
trainable layer by itself. Sums over batches are taken in the JAX engine's
order and dtype. Calibration at 1024 tokens or more on a CUDA device runs
attention through the flash-attention kernels (:meth:`_maybe_enable_flash_sweep`).

The prefix split (``GraspConfig.prefix``): no round ever changes a layer below
the lowest target layer, so a dense sweep starts at that boundary from its
activation, computed under ``no_grad`` every batch ("recompute") or once per
batch and kept on the device ("cache"). The SVDs of a round or chunk run
before its sweep; with ``svd_method="gram_device"`` selection runs after it
on the gram basis without the larger singular factor
(:meth:`_select_compile_one_ufree`).

Not ported (ROADMAP.md, never ported): ``prefix="cache_host"`` and the
bandwidth-driven choice of it, growing sweep chunks, base parking, compile
prefetch, the fused one-dispatch sweeps, stacked gram groups; MoE layers and
a device mesh raise NotImplementedError.
"""

from __future__ import annotations

import dataclasses
import json
import logging
import os
import time
from typing import Any, Dict, Iterable, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from grasp_tpu_torch.checkpoints import META_NAME, load_checkpoint, save_checkpoint
from grasp_tpu_torch.configs import GraspConfig, ModelConfig
from grasp_tpu_torch.models.convert import flatten_params, map_params
from grasp_tpu_torch.models.llama import (
    ATTN_PROJS,
    MLP_PROJS,
    PROJ_ORDER,
    ModelPlan,
    Params,
    default_plan,
    forward,
    hf_causal_lm_loss,
    plan_set,
    torch_dtype,
)
from grasp_tpu_torch.ops.saliency import (
    adaptive_rank_selection,
    bi_from_hiddens,
    choose_prune_layers,
    preserve_rank,
    select_topk,
    svd_saliency,
)
from grasp_tpu_torch.ops.svd import (
    gram_basis,
    lowrank_factors,
    merge_svd,
    sigma_gradients,
    svd,
    truncate_svd,
    ufree_sigma_saliency,
    ufree_truncate,
)

logger = logging.getLogger("grasp_tpu_torch")

Batch = Dict[str, Any]
SvdFactors = Tuple[torch.Tensor, torch.Tensor, torch.Tensor]

_SVD_METHODS = ("auto", "device", "host", "gram", "gram_device")
_PREFIX_MODES = ("off", "recompute", "cache", "auto")
RESUME_TAG = "grasp_compression_v1"
# the JAX engine's budget for the selection's eigendecomposition workspace,
# kept in the auto sweep-chunk size's reserve (_auto_sweep_chunk)
_EIGH_ARENA_BUDGET = 1.7e9
# device bytes the auto prefix mode leaves free beside the boundary cache
_PREFIX_RESERVE = 6 * 2**30


def _resolve_targets(defaults: List[str], targets) -> List[str]:
    """Target list against a block's defaults (the defaults when empty)."""
    return list(targets) if targets else list(defaults)


def module_name(layer_id: int, proj: str) -> str:
    """Reference-compatible module path, e.g. 'model.layers.3.self_attn.q_proj'."""
    group = "self_attn" if proj in ATTN_PROJS else "mlp"
    return f"model.layers.{layer_id}.{group}.{proj}"


def parse_module_name(name: str) -> Tuple[int, str, str]:
    parts = name.split(".")
    return int(parts[2]), parts[3], parts[4]


class GraspEngine:
    """Holds (params, plan, config) on one device and runs the compression stages."""

    def __init__(self, params: Params, config: ModelConfig, plan: Optional[ModelPlan] = None,
                 svd_method: str = "auto", device: Union[str, torch.device] = "cuda",
                 remat: bool = False):
        """remat: recompute each layer's activations in the sweeps' backward
        instead of keeping them (``GraspConfig.remat`` turns it on as well)."""
        if svd_method not in _SVD_METHODS:
            raise ValueError(f"unknown svd method {svd_method!r}")
        if config.num_local_experts > 0:
            raise NotImplementedError("grasp_tpu_torch does not compress MoE layers yet")
        self.device = torch.device(device)
        self.params = map_params(params, lambda t: t.detach().to(self.device))
        self.config = config
        # the model's own config: self.config may gain the flash switch of
        # the sweeps, which resume snapshots must not record
        self._model_config = config
        self.plan = plan or default_plan(config)
        self.svd_method = svd_method
        self.remat = remat

        self.redundant_layers: List[int] = []
        self.layer_importances: List[float] = []
        # wall-clock seconds per pipeline stage (bi_sweep / grad_sweep / svd /
        # select_compile), summed over rounds; a CUDA device is synchronised
        # at every stage boundary
        self.stage_times: Dict[str, float] = {}
        self.stage_counts: Dict[str, int] = {}
        # per-module compression-ratio overrides, honoured during selection
        self.module_ratios: Dict[str, float] = {}
        self.indices_dict: Dict[str, np.ndarray] = {}
        self.indices_log: Dict[str, np.ndarray] = {}  # accumulated across run() rounds
        self.rank_dict: Dict[str, int] = {}
        self.grasp_values_dict: Dict[str, Dict[str, list]] = {}
        self.grasp_layer_grads: Dict[str, torch.Tensor] = {}
        self.prefix_mode = "off"  # the prefix mode the last dense pipeline resolved to

        self._done_rounds: set = set()  # crash-resume bookkeeping (run())
        self._resume_dir: Optional[str] = None
        self._snap_slot: Optional[str] = None
        self._set_prefix(0, "off")

    def _stage(self, name: str, t_start: float) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        self.stage_times[name] = self.stage_times.get(name, 0.0) + time.time() - t_start
        self.stage_counts[name] = self.stage_counts.get(name, 0) + 1

    def _place_batch(self, batch: Batch) -> Dict[str, Optional[torch.Tensor]]:
        """A calibration batch (numpy or tensors) as int64 tensors on the device."""
        def place(v):
            t = v if isinstance(v, torch.Tensor) else torch.as_tensor(np.asarray(v))
            return t.to(self.device).long()

        return {k: None if v is None else place(v) for k, v in batch.items()}

    # ------------------------------------------------------------------
    # param-tree helpers
    # ------------------------------------------------------------------

    def _get_proj(self, name: str) -> Params:
        layer_id, group, proj = parse_module_name(name)
        return self.params["layers"][layer_id][group][proj]

    def _set_proj(self, name: str, new_params: Params, kind: str) -> None:
        layer_id, group, proj = parse_module_name(name)
        self.params["layers"][layer_id][group][proj] = new_params
        self.plan = plan_set(self.plan, layer_id, proj, kind)

    def _with_leaves(self, leaves: Dict[str, torch.Tensor], key: str) -> Params:
        """A params tree that shares every tensor with ``self.params`` except
        ``key`` of the named projections, which comes from ``leaves``."""
        layers = list(self.params["layers"])
        for name, leaf in leaves.items():
            li, group, proj = parse_module_name(name)
            layer = dict(layers[li])
            grp = dict(layer[group])
            grp[proj] = {**grp[proj], key: leaf}
            layer[group] = grp
            layers[li] = layer
        return {**self.params, "layers": layers}

    def svd_module_names(self) -> List[str]:
        """All module paths currently in full-SVD (trainable-S) form."""
        return [module_name(li, proj) for li, layer_plan in enumerate(self.plan)
                for proj, kind in zip(PROJ_ORDER, layer_plan) if kind == "svd"]

    def param_counts(self) -> Tuple[int, int]:
        """(total, trainable): trainable = S leaves of svd modules."""
        total = sum(t.numel() for t in flatten_params(self.params).values())
        trainable = sum(self._get_proj(n)["s"].numel() for n in self.svd_module_names())
        return total, trainable

    # ------------------------------------------------------------------
    # Stage 1: block influence
    # ------------------------------------------------------------------

    def compute_bi(self, num_prune_layers: int = 1,
                   calibration_batches: Optional[Iterable[Batch]] = None,
                   hiddens: Optional[Sequence[torch.Tensor]] = None,
                   angular: bool = False) -> Tuple[List[float], List[int]]:
        """Score layers by block influence and pick the ``num_prune_layers``
        least important: one forward per batch, the per-batch scores summed
        on the host in float64."""
        logger.info("=======> Compute Block Influence")
        t_stage = time.time()
        importances = np.zeros(self.config.num_hidden_layers, dtype=np.float64)
        if hiddens is not None:
            scores = bi_from_hiddens(hiddens, num_prune_layers, angular).cpu().numpy()
            importances[: len(scores)] += scores
        else:
            if calibration_batches is None:
                raise ValueError("please provide hidden_states or calibration batches to "
                                 "compute block influence")
            with torch.no_grad():
                for batch in calibration_batches:
                    batch = self._place_batch(batch)
                    out = forward(self.params, batch["input_ids"], config=self.config,
                                  plan=self.plan, attention_mask=batch.get("attention_mask"),
                                  output_hidden_states=True)
                    scores = bi_from_hiddens(out["hidden_states"], num_prune_layers, angular)
                    scores = scores.cpu().numpy()
                    importances[: len(scores)] += scores
        # scores exist for indices [0, L+1-n); zeros beyond, as in the reference
        self.layer_importances = importances.tolist()
        self.redundant_layers = choose_prune_layers(importances, num_prune_layers, angular)
        self._stage("bi_sweep", t_stage)
        return self.layer_importances, self.redundant_layers

    def remove_layers(self, layers_to_remove: Optional[List[int]] = None, angular: bool = False,
                      num_prune_layers: Optional[int] = None) -> List[int]:
        """Delete whole transformer layers (ShortGPT-style): rebuilds params,
        plan and config without them. Returns the removed layer ids."""
        if not layers_to_remove:
            if not self.layer_importances:
                raise ValueError("Need to compute importances with compute_bi()")
            if not num_prune_layers:
                raise ValueError("Need number of layers to prune")
            layers_to_remove = choose_prune_layers(
                np.asarray(self.layer_importances), num_prune_layers, angular=angular)
        gone = set(layers_to_remove)
        keep = [i for i in range(self.config.num_hidden_layers) if i not in gone]
        self.params = {**self.params, "layers": [self.params["layers"][i] for i in keep]}
        self.plan = tuple(self.plan[i] for i in keep)
        self.config = dataclasses.replace(self.config, num_hidden_layers=len(keep))
        self._model_config = dataclasses.replace(self._model_config, num_hidden_layers=len(keep))
        return list(layers_to_remove)

    # ------------------------------------------------------------------
    # Stage 2: SVD-ify a block
    # ------------------------------------------------------------------

    def _block_targets(self, layer_id: int, block_type: str) -> List[str]:
        """Default target projections of one block."""
        if block_type == "attention":
            return list(ATTN_PROJS)
        if block_type == "mlp":
            if "moe" in self.params["layers"][layer_id]:
                raise NotImplementedError("grasp_tpu_torch does not compress MoE layers yet")
            return list(MLP_PROJS)
        raise NotImplementedError(f"block type {block_type} not supported")

    def _round_names(self, layer_id: int, block_type: str, target_layer_types) -> List[str]:
        defaults = self._block_targets(layer_id, block_type)
        targets = _resolve_targets(defaults, target_layer_types)
        if not all(t in defaults for t in targets):
            raise ValueError(
                f"values in target layer types not valid, should be one of {defaults}")
        return [module_name(layer_id, p) for p in targets]

    def _svd_of_dense(self, names: List[str]) -> Dict[str, SvdFactors]:
        """SVD of the named dense kernels in the [out, in] layout; kernels of
        one shape are stacked into one batched call."""
        t_stage = time.time()
        by_shape: Dict[Tuple[int, ...], List[str]] = {}
        for n in names:
            by_shape.setdefault(tuple(self._get_proj(n)["kernel"].shape), []).append(n)
        out: Dict[str, SvdFactors] = {}
        for group in by_shape.values():
            stack = torch.stack([self._get_proj(n)["kernel"].T.float() for n in group])
            u, s, vh = svd(stack, method=self.svd_method)
            for i, n in enumerate(group):
                out[n] = (u[i], s[i], vh[i])
        self._stage("svd", t_stage)
        return out

    def compress_block(self, layer_id: int, block_type: str,
                       target_layer_types: Optional[Union[List[str], str]] = None) -> bool:
        """Replace each target projection of one block with its full SVD
        (u, s, vh in float32). Returns True ("skip") when
        ``target_layer_types`` is None, the reference's skip-flag contract."""
        if layer_id is None:
            raise ValueError("Layer id should be given, but got None")
        if target_layer_types is None:
            return True
        names = self._round_names(layer_id, block_type, target_layer_types)
        for n, (u, s, vh) in self._svd_of_dense(names).items():
            new: Params = {"u": u, "s": s, "vh": vh}
            if "bias" in self._get_proj(n):
                new["bias"] = self._get_proj(n)["bias"]
            self._set_proj(n, new, "svd")
        return False

    # ------------------------------------------------------------------
    # Stage 3: gradient collection
    # ------------------------------------------------------------------

    def _set_prefix(self, layer: int, mode: str) -> None:
        """Split the dense sweeps at ``layer`` under ``mode`` ("off" splits
        nothing); "cache" keeps each batch's boundary activation, keyed by
        the batch's index, until the split is reset."""
        self._prefix_layer = 0 if mode == "off" else layer
        self._prefix_mode = mode
        self._prefix_cache: Optional[Dict[int, torch.Tensor]] = (
            {} if mode == "cache" and self._prefix_layer else None)

    def _prefix_params(self) -> Params:
        """The part of the params the prefix forward reads: the embedding and
        the layers below the boundary. Tensors are shared, not copied."""
        return {"embed_tokens": self.params["embed_tokens"],
                "layers": list(self.params["layers"][: self._prefix_layer])}

    def _prefix_hidden(self, i: int, batch: Dict[str, Optional[torch.Tensor]]) -> torch.Tensor:
        """The boundary activation of batch ``i``: the input of layer
        ``_prefix_layer``, from the cache or from a forward under no_grad
        (timed as the ``prefix_fwd`` stage)."""
        if self._prefix_cache is not None and i in self._prefix_cache:
            return self._prefix_cache[i]
        t_stage = time.time()
        with torch.no_grad():
            h0 = forward(self._prefix_params(), batch["input_ids"], config=self.config,
                         plan=self.plan, attention_mask=batch.get("attention_mask"),
                         stop_layer=self._prefix_layer)["hidden"]
        self._stage("prefix_fwd", t_stage)
        if self._prefix_cache is not None:
            self._prefix_cache[i] = h0
        return h0

    def _choose_prefix_cache(self, calibration_batches: Sequence[Batch]) -> str:
        """The prefix mode "auto" takes once the split saves 4 layers or
        more: "recompute" off the card (the tests' memory stays flat), and on
        the card "cache" when every batch's boundary activation fits in the
        free device memory beside a reserve of 6 GiB, else "recompute"."""
        if self.device.type != "cuda":
            return "recompute"
        rows = sum(int(np.shape(b["input_ids"])[0]) for b in calibration_batches)
        seq = int(np.shape(calibration_batches[0]["input_ids"])[-1])
        itemsize = torch_dtype(self.config.dtype).itemsize
        need = rows * seq * self.config.hidden_size * itemsize
        free, _ = torch.cuda.mem_get_info(self.device)
        return "cache" if need < free - _PREFIX_RESERVE else "recompute"

    def _resolve_prefix(self, mode: str, p_min: int, calibration_batches: Sequence[Batch]) -> str:
        if mode == "auto":
            mode = "off" if p_min < 4 else self._choose_prefix_cache(calibration_batches)
            logger.info("prefix auto -> %s", mode)
        self.prefix_mode = mode
        return mode

    def _sweep(self, leaves: Dict[str, torch.Tensor], key: str,
               calibration_batches: Iterable[Batch], start_layer: int = 0
               ) -> Dict[str, torch.Tensor]:
        """Sum over batches of dLoss/d(leaf): every leaf is a trainable copy
        of one projection's ``key`` tensor, everything else is frozen. With
        ``start_layer`` the forward starts from the prefix's boundary
        activation (:meth:`_prefix_hidden`)."""
        params = self._with_leaves(leaves, key)
        names = list(leaves)
        totals = {n: torch.zeros_like(leaves[n]) for n in names}
        total_loss, nbatches = 0.0, 0
        for i, batch in enumerate(calibration_batches):
            batch = self._place_batch(batch)
            h0 = self._prefix_hidden(i, batch) if start_layer else None
            logits = forward(params, batch["input_ids"], config=self.config, plan=self.plan,
                             attention_mask=batch.get("attention_mask"), remat=self.remat,
                             start_layer=start_layer, hidden_in=h0)["logits"]
            loss = hf_causal_lm_loss(logits, batch["labels"])
            grads = torch.autograd.grad(loss, [leaves[n] for n in names])
            for n, g in zip(names, grads):
                totals[n] += g
            total_loss += float(loss.detach())
            nbatches += 1
        logger.info("gradient sweep: %d batches, mean loss %.4f", nbatches,
                    total_loss / max(nbatches, 1))
        return totals

    def get_svdlayer_gradients(self, calibration_batches: Iterable[Batch]
                               ) -> Dict[str, torch.Tensor]:
        """Sum of dL/dS over all calibration batches for every SVD module."""
        names = self.svd_module_names()
        if not names:
            raise RuntimeError("no SVD modules found: call compress_block first")
        t_stage = time.time()
        leaves = {n: self._get_proj(n)["s"].detach().requires_grad_() for n in names}
        self.grasp_layer_grads = self._sweep(leaves, "s", calibration_batches)
        self._stage("grad_sweep", t_stage)
        return self.grasp_layer_grads

    def get_dense_gradients(self, names: List[str], calibration_batches: Iterable[Batch]
                            ) -> Dict[str, torch.Tensor]:
        """Sum over batches of dL/d(kernel) for the named dense projections,
        in each kernel's dtype. The sweep starts at the prefix boundary when
        every named layer lies at or above it."""
        for n in names:
            if "kernel" not in self._get_proj(n):
                raise ValueError(f"{n} is not a dense projection")
        split = {parse_module_name(n)[0] for n in names}
        sl = self._prefix_layer if all(li >= self._prefix_layer for li in split) else 0
        t_stage = time.time()
        leaves = {n: self._get_proj(n)["kernel"].detach().requires_grad_() for n in names}
        totals = self._sweep(leaves, "kernel", calibration_batches, start_layer=sl)
        self._stage("grad_sweep", t_stage)
        return totals

    # ------------------------------------------------------------------
    # Stage 4: select and compile (dense-gradient path)
    # ------------------------------------------------------------------

    def compress_round(self, layer_id: int, block_type: str,
                       target_layer_types: Optional[Union[List[str], str]],
                       calibration_batches: Sequence[Batch], cfg: GraspConfig,
                       svd_after: bool = False) -> bool:
        """One (layer, block) compression round on the dense-gradient path:
        SVD of the round's dense kernels, one gradient sweep with respect to
        them, then selection and compilation. ``svd_after``: factor after
        the sweep instead (:meth:`_select_compile_after_sweep`; the run
        takes it for ``gram_device``). Returns True when skipped."""
        if target_layer_types is None:
            return True
        names = self._round_names(layer_id, block_type, target_layer_types)
        logger.info("compress round: layer %d %s (%d targets)", layer_id, block_type, len(names))
        if svd_after:
            grads = self.get_dense_gradients(names, calibration_batches)
            self._select_compile_after_sweep(names, grads, cfg)
            return False
        svd_out = self._svd_of_dense(names)
        grads = self.get_dense_gradients(names, calibration_batches)
        self._select_compile_many(names, svd_out, grads, cfg)
        return False

    def _sweep_chunks(self, layer_names: List[Tuple[int, List[str]]], cfg: GraspConfig
                      ) -> List[List[Tuple[int, List[str]]]]:
        """The parallel path's layers cut into one sweep each chunk:
        ``sweep_chunk_layers`` N layers a chunk, 0 one sweep, None as
        :meth:`_auto_sweep_chunk` says. Chunks are end-aligned, the
        remainder first ([1, 2, 2, 2] for 7 layers at N=2): the first chunk
        sweeps next to the whole uncompressed model, every later one next to
        compressed layers. Layer order is kept."""
        n = cfg.sweep_chunk_layers
        if n is None:
            n = self._auto_sweep_chunk(layer_names)
        if not n or n <= 0 or n >= len(layer_names):
            return [layer_names]
        out = []
        i = len(layer_names)
        while i > 0:
            take = min(n, i)
            out.append(layer_names[i - take:i])
            i -= take
        out.reverse()
        return out

    def _auto_sweep_chunk(self, layer_names: List[Tuple[int, List[str]]]) -> int:
        """The most layers a sweep whose gradient accumulators (one
        kernel-sized tensor a target) fit beside the live params and a
        reserve for the sweep and the selection: the card's memory
        (``torch.cuda.mem_get_info``) less the params less max(1 GiB, the
        eigendecomposition budget) + 1.2 GiB. 0 (one sweep) when all fit,
        and always off the card."""
        if self.device.type != "cuda":
            return 0
        _, limit = torch.cuda.mem_get_info(self.device)
        params_bytes = sum(t.numel() * t.element_size()
                           for t in flatten_params(self.params).values())
        reserve = max(2**30, _EIGH_ARENA_BUDGET) + 1.2 * 2**30
        budget = limit - params_bytes - reserve
        per_layer = max(sum(self._get_proj(n)["kernel"].numel()
                            * self._get_proj(n)["kernel"].element_size() for n in nn)
                        for _, nn in layer_names)
        if budget >= per_layer * len(layer_names):
            return 0
        return max(1, int(budget // per_layer))

    def _select_compile_many(self, names: List[str], svd_out: Dict[str, SvdFactors],
                             grads: Dict[str, torch.Tensor], cfg: GraspConfig) -> None:
        """Select, truncate and compile every module in ``names``."""
        t_stage = time.time()
        indices_dict: Dict[str, np.ndarray] = {}
        for n in names:
            u, s, vh = svd_out.pop(n)
            # dL/dkernel [in, out] -> dL/dW [out, in]
            self._select_compile_one(n, u, s, vh, grads.pop(n).T, cfg, indices_dict)
        self._record_selection(indices_dict, cfg, t_stage)

    def _select_compile_after_sweep(self, names: List[str], grads: Dict[str, torch.Tensor],
                                    cfg: GraspConfig) -> None:
        """Select, truncate and compile ``names`` from summed dense gradients,
        factoring one matrix at a time after the sweep: ``gram_device``
        selects on the gram basis (:meth:`_select_compile_one_ufree`), every
        other method through its full factors."""
        t_stage = time.time()
        indices_dict: Dict[str, np.ndarray] = {}
        for n in names:
            t_one = time.time()
            if self.svd_method == "gram_device":
                self._select_compile_one_ufree(n, grads.pop(n), cfg, indices_dict)
            else:
                u, s, vh = self._svd_of_dense([n]).pop(n)
                self._select_compile_one(n, u, s, vh, grads.pop(n).T, cfg, indices_dict)
            self._stage("svd_select_one", t_one)
        self._record_selection(indices_dict, cfg, t_stage)

    def _record_selection(self, indices_dict: Dict[str, np.ndarray], cfg: GraspConfig,
                          t_stage: float) -> None:
        self.indices_dict = indices_dict
        self.indices_log.update(indices_dict)
        self._stage("select_compile", t_stage)
        if cfg.verbose:
            for n, idx in indices_dict.items():
                logger.info("%s: %s", n, idx[:128].tolist())

    def _maybe_enable_flash_sweep(self, calibration_batches: Sequence[Batch]) -> None:
        """Route long-sequence calibration sweeps through the flash-attention
        kernels: at 1024 tokens or more the plain path writes an [S, S] score
        matrix per head to device memory, which the kernels never do. Only on
        a CUDA device (the kernels have no CPU path); ``GRASP_FLASH_SWEEP=0``
        keeps the plain path. The kernels sum in another order, so a sweep's
        gradients differ from the plain path's at float tolerance."""
        if (os.environ.get("GRASP_FLASH_SWEEP", "1") != "0"
                and not self.config.use_flash_attention
                and self.device.type == "cuda"
                and len(calibration_batches) > 0
                and np.shape(calibration_batches[0]["input_ids"])[-1] >= 1024):
            self.config = dataclasses.replace(self.config, use_flash_attention=True)
            logger.info("calibration seq >= 1024 on CUDA: sweeps use flash attention")

    def _select_indices(self, n: str, importance: torch.Tensor, s: torch.Tensor, in_f: int,
                        out_f: int, compression_ratio: Optional[float],
                        threshold_ratio: Optional[float]) -> np.ndarray:
        """Rank selection (fixed ratio or adaptive) + inspection bookkeeping."""
        ratio = self.module_ratios.get(n, compression_ratio)
        importance_np = importance.detach().cpu().numpy()
        if ratio is not None:
            k = preserve_rank(in_f, out_f, ratio)
            indices = select_topk(importance.detach(), k).cpu().numpy()
        else:
            if not threshold_ratio:
                raise ValueError("Please provide Taylor threshold to select rank adaptively")
            indices = np.asarray(adaptive_rank_selection(importance_np, threshold_ratio))
        self.grasp_values_dict[n] = {
            "svd_importance": np.round(importance_np, 3).tolist(),
            "svd_value": np.round(s.detach().cpu().numpy(), 3).tolist(),
        }
        return indices

    def _compile_truncated(self, n: str, ut: torch.Tensor, st: torch.Tensor, vht: torch.Tensor,
                           dtype: torch.dtype, merge: bool, sigma_fuse: str) -> None:
        """Materialise the compiled module (merged dense or low-rank pair) in
        ``dtype``: the SVD runs in fp32, but fp32 factors inside a bf16 model
        would not multiply with its activations."""
        self.rank_dict[n] = int(st.shape[-1])
        bias = self._get_proj(n).get("bias")
        if merge:
            new: Params = {"kernel": merge_svd(ut, st, vht).T.to(dtype).contiguous()}
            kind = "dense"
        else:
            in_kernel, out_kernel = lowrank_factors(ut, st, vht, sigma_fuse)
            new = {"in_kernel": in_kernel.to(dtype).contiguous(),
                   "out_kernel": out_kernel.to(dtype).contiguous()}
            kind = "lowrank"
        if bias is not None:
            new["bias"] = bias
        self._set_proj(n, new, kind)

    def _select_compile_one(self, n: str, u: torch.Tensor, s: torch.Tensor, vh: torch.Tensor,
                            grad_w: torch.Tensor, cfg: GraspConfig,
                            indices_dict: Dict[str, np.ndarray]) -> None:
        """Saliency-project, select, truncate and compile one module."""
        importance = svd_saliency(sigma_gradients(u, vh, grad_w), s, cfg.metric)
        indices = self._select_indices(n, importance, s, vh.shape[-1], u.shape[-2],
                                       cfg.compression_ratio, cfg.threshold_ratio)
        indices_dict[n] = indices
        ut, st, vht = truncate_svd(u, s, vh, indices)
        self._compile_truncated(n, ut, st, vht, self._get_proj(n)["kernel"].dtype,
                                cfg.merge, cfg.sigma_fuse)

    def _select_compile_one_ufree(self, n: str, grad_kernel: torch.Tensor, cfg: GraspConfig,
                                  indices_dict: Dict[str, np.ndarray]) -> None:
        """Select, truncate and compile one module on the gram basis of its
        smaller side (ops.svd.gram_basis), never forming the larger singular
        factor: the eigendecomposition (``sel_eigh``), the importances
        (``sel_importance``) and the kept columns (``sel_truncate``).
        grad_kernel: dL/d(kernel) in the [in, out] layout."""
        kernel = self._get_proj(n)["kernel"]  # [in, out]
        w = kernel.T
        t_sub = time.time()
        s, basis, side = gram_basis(w)
        self._stage("sel_eigh", t_sub)
        t_sub = time.time()
        importance = ufree_sigma_saliency(w, grad_kernel.T, s, basis, side, cfg.metric)
        indices = self._select_indices(n, importance, s, kernel.shape[-2], kernel.shape[-1],
                                       cfg.compression_ratio, cfg.threshold_ratio)
        indices_dict[n] = indices
        self._stage("sel_importance", t_sub)
        t_sub = time.time()
        ut, st, vht = ufree_truncate(w, s, basis, side, indices)
        self._compile_truncated(n, ut, st, vht, kernel.dtype, cfg.merge, cfg.sigma_fuse)
        self._stage("sel_truncate", t_sub)

    # ------------------------------------------------------------------
    # Stage 4/5 on SVD modules (grad_mode="svd")
    # ------------------------------------------------------------------

    def dynamic_svd_selection(self, grasp_layer_grads: Optional[Dict[str, torch.Tensor]] = None,
                              metric: str = "taylor", compression_ratio: Optional[float] = None,
                              threshold_ratio: Optional[float] = None,
                              verbose: bool = False) -> Dict[str, np.ndarray]:
        """Pick which singular triplets to keep per SVD module: descending
        importance, the lower index first on ties."""
        if not grasp_layer_grads:
            grasp_layer_grads = self.grasp_layer_grads
        if not grasp_layer_grads:
            raise ValueError("gradients of svd layers should be given, but got None")
        indices_dict: Dict[str, np.ndarray] = {}
        for name, grad in grasp_layer_grads.items():
            mod = self._get_proj(name)
            importance = svd_saliency(grad, mod["s"], metric)
            indices_dict[name] = self._select_indices(
                name, importance, mod["s"], mod["vh"].shape[1], mod["u"].shape[0],
                compression_ratio, threshold_ratio)
        if verbose:
            for name, idx in indices_dict.items():
                logger.info("%s: %s", name, idx[:128].tolist())
        self.indices_dict = indices_dict
        self.indices_log.update(indices_dict)
        return indices_dict

    def compile_grasp_model(self, indices_dict: Optional[Dict[str, np.ndarray]] = None,
                            merge: bool = False, sigma_fuse: str = "UV") -> None:
        """Truncate the kept triplets of every SVD module and materialise the
        compiled module, in the model's dtype."""
        if indices_dict is None:
            indices_dict = self.indices_dict
        t_stage = time.time()
        dtype = torch_dtype(self.config.dtype)
        for name, indices in indices_dict.items():
            mod = self._get_proj(name)
            ut, st, vht = truncate_svd(mod["u"], mod["s"], mod["vh"], indices)
            self._compile_truncated(name, ut, st, vht, dtype, merge, sigma_fuse)
        self._stage("select_compile", t_stage)

    # ------------------------------------------------------------------
    # Crash-resume snapshots
    # ------------------------------------------------------------------

    def _mark_round_done(self, layer_id, block_type) -> None:
        self._done_rounds.add((layer_id, block_type))
        if self._resume_dir:
            self._snapshot_rounds(self._resume_dir)

    def _snapshot_rounds(self, resume_dir: str) -> None:
        """Write the engine's compression state (params, plan, ranks, layers,
        the done rounds) as a port checkpoint tagged ``grasp_compression_v1``,
        with the model's own config. Crash-safe: params alternate between two
        files, so the file the committed meta names is never written; the
        meta is committed last (checkpoints.save_checkpoint) and the file it
        no longer names is removed only after that."""
        t_stage = time.time()
        cur = self._snap_slot
        nxt = "params-b.pt" if cur == "params-a.pt" else "params-a.pt"
        save_checkpoint(resume_dir, self.params, self._model_config, self.plan,
                        rank_dict=self.rank_dict, redundant_layers=self.redundant_layers,
                        layer_importances=self.layer_importances,
                        extra={"resume": RESUME_TAG,
                               "done_rounds": [list(r) for r in self._done_rounds]},
                        params_file=nxt)
        self._snap_slot = nxt
        if cur and cur != nxt:  # a kill here leaves a file nobody names
            try:
                os.remove(os.path.join(resume_dir, cur))
            except FileNotFoundError:
                pass
        self._stage("resume_snapshot", t_stage)

    def _restore_rounds(self, resume_dir: str) -> bool:
        """Restore a :meth:`_snapshot_rounds` snapshot if ``resume_dir`` holds
        one: params, plan, ranks, layers and done rounds are replaced and
        block influence is not recomputed. Returns whether it restored. The
        caller passes the cfg and calibration batches of the first run:
        rounds are known by (layer, block) only. Refuses a directory that
        is not such a snapshot, or one of another model config."""
        meta_path = os.path.join(resume_dir, META_NAME)
        if not os.path.exists(meta_path):
            return False
        with open(meta_path) as f:
            meta = json.load(f)
        if meta.get("extra", {}).get("resume") != RESUME_TAG:
            raise ValueError(f"{resume_dir} is not a compression-resume snapshot")
        params, config, plan, meta = load_checkpoint(resume_dir, self.device)
        if config.to_json() != self._model_config.to_json():
            raise ValueError("resume snapshot was written for a different model config")
        self.params = params
        self.plan = plan
        self.rank_dict = dict(meta.get("rank_dict", {}))
        self.redundant_layers = list(meta.get("redundant_layers", []))
        self.layer_importances = list(meta.get("layer_importances", []))
        self._done_rounds = {tuple(r) for r in meta["extra"].get("done_rounds", [])}
        # the next snapshot must not write over the file just restored from
        self._snap_slot = meta["params_file"]
        logger.info("=======> Resumed compression from %s (%d rounds done)", resume_dir,
                    len(self._done_rounds))
        return True

    # ------------------------------------------------------------------
    # Full pipeline
    # ------------------------------------------------------------------

    def run(self, calibration_batches: Sequence[Batch], cfg: GraspConfig,
            resume_dir: Optional[str] = None) -> Dict[str, Any]:
        """End-to-end compression in the reference's order: block influence,
        then per redundant layer (descending id) the MLP block and the
        attention block, each with its own calibration gradient sweep that
        sees every earlier truncation (``sweep="sequential"``); or one sweep
        for every target (``sweep="parallel"``, in chunks of
        ``sweep_chunk_layers`` layers on the dense path), where a layer's
        gradients do not see the other targets' truncations.

        resume_dir: the engine snapshots its state there after block
        influence and after every done round; a run over the same directory
        (same cfg, same batches) restores it and goes on at the first round
        not done, to the state of an uninterrupted run."""
        if cfg.grad_mode not in ("dense", "svd"):
            raise ValueError(f"unknown grad_mode {cfg.grad_mode!r}")
        if cfg.sweep not in ("sequential", "parallel"):
            raise ValueError(f"unknown sweep {cfg.sweep!r}")
        if cfg.prefix == "cache_host":
            raise NotImplementedError(
                "grasp_tpu_torch does not support prefix='cache_host' (host parking of the "
                "boundary activations); use 'cache' or 'recompute'")
        if cfg.prefix not in _PREFIX_MODES:
            raise ValueError(f"unknown prefix {cfg.prefix!r}")
        t0 = time.time()
        self.remat = self.remat or cfg.remat
        self._maybe_enable_flash_sweep(calibration_batches)
        self._done_rounds = set()
        self._resume_dir, self._snap_slot = resume_dir, None
        resumed = bool(resume_dir) and self._restore_rounds(resume_dir)

        if resumed:
            layers_id = list(self.redundant_layers)
        else:
            layers_id = cfg.layers_id
            if layers_id is None:
                importances, layers_id = self.compute_bi(
                    num_prune_layers=cfg.num_prune_layers,
                    calibration_batches=calibration_batches, angular=cfg.angular)
                logger.info("Layer importance measure by BI:\n%s", importances)
            if isinstance(layers_id, int):
                layers_id = [layers_id]
        self.redundant_layers = list(layers_id)
        if resume_dir and not resumed:
            self._snapshot_rounds(resume_dir)  # block influence done, no round yet
        layers_id = sorted(layers_id, reverse=True)

        logger.info("=======> Start Compressing model with GRASP")
        # None targets = skip that block entirely (the reference's skip flag)
        blocks = (
            ("mlp", None if cfg.mlp_target_layer_types is None
             else tuple(cfg.mlp_target_layer_types)),
            ("attention", None if cfg.attn_target_layer_types is None
             else tuple(cfg.attn_target_layer_types)),
        )
        if cfg.grad_mode == "dense":
            self._run_dense(layers_id, blocks, calibration_batches, cfg)
        elif cfg.sweep == "parallel":
            if ("all", "all") not in self._done_rounds:  # one resumable unit
                skipped = [self.compress_block(layer_id, block_type, targets)
                           for layer_id in layers_id for block_type, targets in blocks]
                if not all(skipped):
                    self._select_compile_svd(calibration_batches, cfg)
                self._mark_round_done("all", "all")
        else:
            for layer_id in layers_id:
                for block_type, targets in blocks:
                    if (layer_id, block_type) in self._done_rounds:
                        continue
                    if self.compress_block(layer_id, block_type, targets):
                        logger.info("=======> Skip Compressing This Block")
                    else:
                        self._select_compile_svd(calibration_batches, cfg)
                    self._mark_round_done(layer_id, block_type)

        wall = time.time() - t0
        logger.info("=======> Done! (%.1fs)", wall)
        return {
            "redundant_layers": self.redundant_layers,
            "rank_dict": dict(self.rank_dict),
            "layer_importances": list(self.layer_importances),
            "wall_clock_s": wall,
            "stage_times_s": {k: round(v, 2) for k, v in self.stage_times.items()},
            "prefix": self.prefix_mode,
        }

    def _select_compile_svd(self, calibration_batches: Sequence[Batch], cfg: GraspConfig) -> None:
        """grad_mode="svd": one sweep over every SVD module, selection, compilation."""
        grads = self.get_svdlayer_gradients(calibration_batches)
        indices = self.dynamic_svd_selection(
            grads, metric=cfg.metric, compression_ratio=cfg.compression_ratio,
            threshold_ratio=cfg.threshold_ratio, verbose=cfg.verbose)
        self.compile_grasp_model(indices, merge=cfg.merge, sigma_fuse=cfg.sigma_fuse)

    def _run_dense(self, layers_id: List[int], blocks, calibration_batches: Sequence[Batch],
                   cfg: GraspConfig) -> None:
        """The dense-gradient pipeline. Sequential: one round per (layer,
        block) in the reference's order, each sweep seeing every earlier
        truncation. Parallel: the targets of all layers in chunks
        (:meth:`_sweep_chunks`), one sweep a chunk, then selection and
        compilation of the chunk. Either way the sweeps start at the lowest
        target layer under ``cfg.prefix``."""
        after = self.svd_method == "gram_device"
        if cfg.sweep == "parallel":
            if ("all", "all") in self._done_rounds:
                return
            layer_names: List[Tuple[int, List[str]]] = []
            for layer_id in layers_id:
                nn = [n for block_type, targets in blocks if targets is not None
                      for n in self._round_names(layer_id, block_type, targets)]
                if nn:
                    layer_names.append((layer_id, nn))
            if not layer_names:
                return
            p_min = min(lid for lid, _ in layer_names)
            self._set_prefix(p_min, self._resolve_prefix(cfg.prefix, p_min, calibration_batches))
            try:
                chunks = self._sweep_chunks(layer_names, cfg)
                if len(chunks) > 1:
                    logger.info("parallel sweep in %d chunks: %s", len(chunks),
                                [[lid for lid, _ in c] for c in chunks])
                for chunk in chunks:
                    key = ("chunk", ".".join(str(lid) for lid, _ in chunk))
                    if key in self._done_rounds:
                        continue
                    names = [n for _, nn in chunk for n in nn]
                    if after:
                        self._select_compile_after_sweep(
                            names, self.get_dense_gradients(names, calibration_batches), cfg)
                    else:
                        svd_out = self._svd_of_dense(names)
                        grads = self.get_dense_gradients(names, calibration_batches)
                        self._select_compile_many(names, svd_out, grads, cfg)
                    self._mark_round_done(*key)
            finally:
                self._set_prefix(0, "off")
            self._mark_round_done("all", "all")
            return

        rounds = []
        for layer_id in layers_id:
            for block_type, targets in blocks:
                if targets is None:
                    logger.info("=======> Skip Compressing This Block")
                elif (layer_id, block_type) not in self._done_rounds:
                    rounds.append((layer_id, block_type, targets))
        p_min = min((lid for lid, _, _ in rounds), default=0)
        self._set_prefix(p_min, self._resolve_prefix(cfg.prefix, p_min, calibration_batches))
        try:
            for layer_id, block_type, targets in rounds:
                self.compress_round(layer_id, block_type, targets, calibration_batches, cfg,
                                    svd_after=after)
                self._mark_round_done(layer_id, block_type)
        finally:
            self._set_prefix(0, "off")
