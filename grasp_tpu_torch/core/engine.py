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
  - :meth:`run`                    the whole pipeline, sequential sweeps

Gradients come from autograd over leaf copies of the trainable tensors; every
other parameter is frozen, so the backward pass stops below the lowest
trainable layer by itself. Sums over batches are taken in the JAX engine's
order and dtype. Calibration at 1024 tokens or more on a CUDA device runs
attention through the flash-attention kernels (:meth:`_maybe_enable_flash_sweep`).

Not ported yet (each raises NotImplementedError): ``sweep="parallel"``,
``resume_dir``, a ``prefix`` other than "off" ("auto" resolves to "off"), the
gram SVD methods, MoE layers, a device mesh.
"""

from __future__ import annotations

import dataclasses
import logging
import os
import time
from typing import Any, Dict, Iterable, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

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
    lowrank_factors,
    merge_svd,
    sigma_gradients,
    svd,
    truncate_svd,
)

logger = logging.getLogger("grasp_tpu_torch")

Batch = Dict[str, Any]
SvdFactors = Tuple[torch.Tensor, torch.Tensor, torch.Tensor]

_SVD_METHODS = ("auto", "device", "host")


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
                 svd_method: str = "auto", device: Union[str, torch.device] = "cuda"):
        if svd_method not in _SVD_METHODS:
            if svd_method in ("gram", "gram_device"):
                raise NotImplementedError(
                    f"grasp_tpu_torch does not support svd_method {svd_method!r} yet")
            raise ValueError(f"unknown svd method {svd_method!r}")
        if config.num_local_experts > 0:
            raise NotImplementedError("grasp_tpu_torch does not compress MoE layers yet")
        self.device = torch.device(device)
        self.params = map_params(params, lambda t: t.detach().to(self.device))
        self.config = config
        self.plan = plan or default_plan(config)
        self.svd_method = svd_method

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

    def _sweep(self, leaves: Dict[str, torch.Tensor], key: str,
               calibration_batches: Iterable[Batch]) -> Dict[str, torch.Tensor]:
        """Sum over batches of dLoss/d(leaf): every leaf is a trainable copy
        of one projection's ``key`` tensor, everything else is frozen."""
        params = self._with_leaves(leaves, key)
        names = list(leaves)
        totals = {n: torch.zeros_like(leaves[n]) for n in names}
        total_loss, nbatches = 0.0, 0
        for batch in calibration_batches:
            batch = self._place_batch(batch)
            logits = forward(params, batch["input_ids"], config=self.config, plan=self.plan,
                             attention_mask=batch.get("attention_mask"))["logits"]
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
        in each kernel's dtype."""
        for n in names:
            if "kernel" not in self._get_proj(n):
                raise ValueError(f"{n} is not a dense projection")
        t_stage = time.time()
        leaves = {n: self._get_proj(n)["kernel"].detach().requires_grad_() for n in names}
        totals = self._sweep(leaves, "kernel", calibration_batches)
        self._stage("grad_sweep", t_stage)
        return totals

    # ------------------------------------------------------------------
    # Stage 4: select and compile (dense-gradient path)
    # ------------------------------------------------------------------

    def compress_round(self, layer_id: int, block_type: str,
                       target_layer_types: Optional[Union[List[str], str]],
                       calibration_batches: Sequence[Batch], cfg: GraspConfig) -> bool:
        """One (layer, block) compression round on the dense-gradient path:
        SVD of the round's dense kernels, one gradient sweep with respect to
        them, then selection and compilation. Returns True when skipped."""
        if target_layer_types is None:
            return True
        names = self._round_names(layer_id, block_type, target_layer_types)
        logger.info("compress round: layer %d %s (%d targets)", layer_id, block_type, len(names))
        svd_out = self._svd_of_dense(names)
        grads = self.get_dense_gradients(names, calibration_batches)
        self._select_compile_many(names, svd_out, grads, cfg)
        return False

    def _select_compile_many(self, names: List[str], svd_out: Dict[str, SvdFactors],
                             grads: Dict[str, torch.Tensor], cfg: GraspConfig) -> None:
        """Select, truncate and compile every module in ``names``."""
        t_stage = time.time()
        indices_dict: Dict[str, np.ndarray] = {}
        for n in names:
            u, s, vh = svd_out.pop(n)
            # dL/dkernel [in, out] -> dL/dW [out, in]
            self._select_compile_one(n, u, s, vh, grads.pop(n).T, cfg, indices_dict)
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
    # Full pipeline
    # ------------------------------------------------------------------

    def run(self, calibration_batches: Sequence[Batch], cfg: GraspConfig,
            resume_dir: Optional[str] = None) -> Dict[str, Any]:
        """End-to-end compression in the reference's order: block influence,
        then per redundant layer (descending id) the MLP block and the
        attention block, each with its own calibration gradient sweep that
        sees every earlier truncation."""
        if resume_dir is not None:
            raise NotImplementedError("grasp_tpu_torch does not support resume_dir yet")
        if cfg.sweep != "sequential":
            raise NotImplementedError(
                f"grasp_tpu_torch does not support sweep={cfg.sweep!r} yet (use 'sequential')")
        if cfg.prefix not in ("off", "auto"):  # "auto" resolves to "off" here
            raise NotImplementedError(
                f"grasp_tpu_torch does not support prefix={cfg.prefix!r} yet (use 'off')")
        if cfg.grad_mode not in ("dense", "svd"):
            raise ValueError(f"unknown grad_mode {cfg.grad_mode!r}")
        t0 = time.time()
        self._maybe_enable_flash_sweep(calibration_batches)

        layers_id = cfg.layers_id
        if layers_id is None:
            importances, layers_id = self.compute_bi(
                num_prune_layers=cfg.num_prune_layers,
                calibration_batches=calibration_batches, angular=cfg.angular)
            logger.info("Layer importance measure by BI:\n%s", importances)
        if isinstance(layers_id, int):
            layers_id = [layers_id]
        self.redundant_layers = list(layers_id)

        logger.info("=======> Start Compressing model with GRASP")
        # None targets = skip that block entirely (the reference's skip flag)
        blocks = (
            ("mlp", None if cfg.mlp_target_layer_types is None
             else tuple(cfg.mlp_target_layer_types)),
            ("attention", None if cfg.attn_target_layer_types is None
             else tuple(cfg.attn_target_layer_types)),
        )
        for layer_id in sorted(layers_id, reverse=True):
            for block_type, targets in blocks:
                if targets is None:
                    logger.info("=======> Skip Compressing This Block")
                elif cfg.grad_mode == "dense":
                    self.compress_round(layer_id, block_type, targets, calibration_batches, cfg)
                else:
                    self.compress_block(layer_id, block_type, targets)
                    grads = self.get_svdlayer_gradients(calibration_batches)
                    indices = self.dynamic_svd_selection(
                        grads, metric=cfg.metric, compression_ratio=cfg.compression_ratio,
                        threshold_ratio=cfg.threshold_ratio, verbose=cfg.verbose)
                    self.compile_grasp_model(indices, merge=cfg.merge,
                                             sigma_fuse=cfg.sigma_fuse)

        wall = time.time() - t0
        logger.info("=======> Done! (%.1fs)", wall)
        return {
            "redundant_layers": self.redundant_layers,
            "rank_dict": dict(self.rank_dict),
            "layer_importances": list(self.layer_importances),
            "wall_clock_s": wall,
            "stage_times_s": {k: round(v, 2) for k, v in self.stage_times.items()},
        }
