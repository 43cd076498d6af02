"""Recovery fine-tuning, GRASP* (counterpart of grasp_tpu/train/recover.py).

After compression only the redundant layers are fine-tuned (every parameter
of each: the low-rank factors and both norms; the reference unfreezes whole
layers, alpaca_grasp.py:76-83), on Alpaca-format instructions, with the
reference Trainer's semantics (alpaca_grasp.py:28-198): AdamW, a linear
warmup of 100 steps then linear decay, global gradient clipping at 1.0 over
the trainable leaves, gradient accumulation of ``batch_size //
micro_batch_size`` micro-batches, either token-weighted (transformers >= 4.46)
or as optax's running mean, eval and save every ``eval_every`` optimizer steps
keeping the newest ``save_total_limit``, the best checkpoint loaded at the end,
and a resume that restores params, optimizer state, step and data position, so
that a killed run reproduces the uninterrupted loss curve.

:class:`Optimizer` computes what the JAX package's optax chain computes, in
the same order and dtypes, rather than ``torch.optim.AdamW``, whose defaults
give other numbers: weight decay 0.0 (not 0.01); the clip ``g`` if the norm
is below the maximum, else ``g / norm * max`` (``clip_grad_norm_`` adds 1e-6);
the learning rate at the step count *before* the increment (a warmup's first
step takes lr 0); eps outside the square root; moments in the parameter's
dtype.

Parameters are the port's nested dicts of tensors, and a step returns new
dicts (the frozen tensors are shared, never copied). Gradients come from
``torch.autograd.grad`` on the trainable leaves alone, in both grad scopes:
"full" masks the optimizer to the trainable leaves of the whole tree,
"layers" runs it over the redundant layers' subtree ``{str(li): layer}``; the
two give equal updates. A model whose config has ``use_pallas_lowrank`` runs
each low-rank projection of 256 rows or more on CUDA through the fused kernel
(ops/lowrank.py), whose backward is plain products.

Not ported: ``mesh=`` raises NotImplementedError; ``scan_layers``,
``split_layers`` and ``_auto_scan_layers`` are XLA machinery.
"""

from __future__ import annotations

import json
import logging
import os
import shutil
import time
from typing import Any, Callable, Dict, Iterable, List, Optional, Tuple

import numpy as np
import torch

from grasp_tpu_torch.configs import ModelConfig
from grasp_tpu_torch.models.convert import flatten_params, map_params, unflatten_params
from grasp_tpu_torch.models.llama import (
    ModelPlan,
    Params,
    forward,
    hf_causal_lm_loss,
    hf_causal_lm_loss_sum,
)

logger = logging.getLogger("grasp_tpu_torch")

Grads = Dict[str, torch.Tensor]  # dotted leaf path -> tensor
B1, B2, EPS = 0.9, 0.999, 1e-8  # optax.adamw's defaults, which the JAX package keeps
MAX_GRAD_NORM = 1.0  # HF Trainer's implicit clip; weight decay is its default 0.0


def _leaf_paths(tree, prefix: str = "") -> List[Tuple[str, Any]]:
    """(dotted path, leaf): dict keys sorted (digit keys by value), lists in
    order. The global norm sums the leaves in this order, so that the "full"
    and "layers" scopes give ``torch.equal`` updates. ``jax.tree`` sorts dict
    keys as strings ('10' before '9'), so the order is JAX's only when every
    redundant layer index has the same number of digits; otherwise the norm
    differs from JAX's by rounding alone."""
    if isinstance(tree, dict):
        keys = sorted(tree, key=lambda k: (0, int(k), "") if k.isdigit() else (1, 0, k))
        items = [(k, tree[k]) for k in keys]
    elif isinstance(tree, (list, tuple)):
        items = [(str(i), v) for i, v in enumerate(tree)]
    else:
        return [(prefix[:-1], tree)]
    out: List[Tuple[str, Any]] = []
    for k, v in items:
        out.extend(_leaf_paths(v, f"{prefix}{k}."))
    return out


def _with_leaves(tree, fn: Callable[[str, Any], Any], prefix: str = ""):
    """A new tree (fresh dicts and lists) with each leaf ``x`` at dotted path
    ``p`` replaced by ``fn(p, x)``."""
    if isinstance(tree, dict):
        return {k: _with_leaves(v, fn, f"{prefix}{k}.") for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_with_leaves(v, fn, f"{prefix}{i}.") for i, v in enumerate(tree)]
    return fn(prefix[:-1], tree)


def trainable_mask(params: Params, redundant_layers: List[int]) -> Params:
    """Boolean tree: True for every leaf inside a redundant layer (the whole
    transformer layer trains, low-rank factors and both layernorms)."""
    redundant = set(redundant_layers)
    mask = map_params(params, lambda _: False)
    mask["layers"] = [map_params(layer, lambda _, on=li in redundant: on)
                      for li, layer in enumerate(params["layers"])]
    return mask


def count_trainable(params: Params, mask: Params) -> Tuple[int, int]:
    leaves, flags = _leaf_paths(params), dict(_leaf_paths(mask))
    return (sum(x.numel() for _, x in leaves),
            sum(x.numel() for p, x in leaves if flags[p]))


def apply_updates(params, updates: Grads):
    """``optax.apply_updates``: p + u in p's dtype for every updated leaf."""
    return _with_leaves(params, lambda p, x: (x + updates[p]).to(x.dtype)
                        if p in updates else x)


# ---------------------------------------------------------------------------
# The optimizer, as optax computes it
# ---------------------------------------------------------------------------


def _linear(init: float, end: float, steps: int, count: int) -> np.float32:
    """``optax.linear_schedule(init, end, steps)(count)`` in float32."""
    if steps <= 0:
        return np.float32(init)
    done = np.float32(min(max(count, 0), steps)) / np.float32(steps)
    return np.float32(init - end) * (np.float32(1) - done) + np.float32(end)


def make_schedule(learning_rate: float, total_steps: int,
                  warmup_steps: int) -> Callable[[int], np.float32]:
    """HF Trainer's linear warmup then linear decay to 0, as optax's joined
    linear schedules compute it, with ``max(total - warmup, 1)`` decay steps."""
    decay = max(total_steps - warmup_steps, 1)

    def schedule(count: int) -> np.float32:
        if count < warmup_steps:
            return _linear(0.0, learning_rate, warmup_steps, count)
        return _linear(learning_rate, 0.0, decay, count - warmup_steps)

    return schedule


def clip_by_global_norm(grads: Grads, max_norm: float) -> Grads:
    """``optax.clip_by_global_norm``: ``g`` where the global norm is below
    ``max_norm``, else ``g / norm * max_norm``; leaves summed in order, each
    in its own dtype. No host sync."""
    total = sum(torch.sum(g * g) for g in grads.values())
    norm = torch.sqrt(total)
    return {p: torch.where(norm < max_norm, g, (g / norm.to(g.dtype)) * max_norm)
            for p, g in grads.items()}


def _scalar(value, like: torch.Tensor) -> torch.Tensor:
    """A 0-dim tensor of ``like``'s dtype and device (torch on CUDA divides
    by a Python number through its reciprocal; by a tensor it divides)."""
    return torch.tensor(float(value), dtype=like.dtype, device=like.device)


class Optimizer:
    """What ``make_optimizer``'s optax chain computes, in this order: drop the
    frozen leaves' gradients, clip by the global norm, AdamW (:data:`B1`,
    :data:`B2`, :data:`EPS` outside the square root, eps_root 0, bias
    corrections ``mu / (1 - b1^t)``, weight decay 0.0) scaled by the negated
    learning rate at the count before the increment. With ``accum_steps >
    1``, ``optax.MultiSteps``: the running mean ``acc + (g - acc) / (n + 1)``
    of the micro-batches' gradients, given to AdamW once a group is full.

    ``mask``: a boolean tree over the params the optimizer is given; only the
    True leaves train (None: every leaf). Gradients and updates are dicts
    keyed by dotted leaf path; the state is a dict of ints and such dicts,
    which ``torch.save`` writes."""

    def __init__(self, schedule: Callable[[int], np.float32], mask: Optional[Params] = None,
                 accum_steps: int = 1):
        self.schedule, self.mask, self.accum_steps = schedule, mask, accum_steps

    def paths(self, params) -> List[str]:
        """The trainable leaves' dotted paths, in leaf order."""
        if self.mask is None:
            return [p for p, _ in _leaf_paths(params)]
        return [p for p, on in _leaf_paths(self.mask) if on]

    def init(self, params) -> Dict[str, Any]:
        leaves = dict(_leaf_paths(params))
        zeros = lambda: {p: torch.zeros_like(leaves[p]) for p in self.paths(params)}  # noqa: E731
        adam = {"count": 0, "mu": zeros(), "nu": zeros()}
        if self.accum_steps > 1:
            return {"mini_step": 0, "gradient_step": 0, "acc": zeros(), "inner": adam}
        return adam

    def update(self, grads: Grads, state: Dict[str, Any], params) -> Tuple[Grads, Dict[str, Any]]:
        """(updates, new state); ``grads`` holds at least every trainable
        path. Between accumulation boundaries the updates are empty.
        ``params`` is optax's argument, which weight decay 0.0 leaves unread."""
        if self.accum_steps == 1:
            return self._adamw(grads, state)
        n = state["mini_step"]
        acc = {p: a + (grads[p] - a) / _scalar(n + 1, a) for p, a in state["acc"].items()}
        if n + 1 < self.accum_steps:
            return {}, {**state, "mini_step": n + 1, "acc": acc}
        updates, inner = self._adamw(acc, state["inner"])
        return updates, {"mini_step": 0, "gradient_step": state["gradient_step"] + 1,
                         "acc": {p: torch.zeros_like(a) for p, a in acc.items()},
                         "inner": inner}

    def _adamw(self, grads: Grads, state: Dict[str, Any]) -> Tuple[Grads, Dict[str, Any]]:
        g = clip_by_global_norm({p: grads[p] for p in state["mu"]}, MAX_GRAD_NORM)
        t = state["count"] + 1
        mu = {p: (1 - B1) * g[p] + B1 * m for p, m in state["mu"].items()}
        nu = {p: (1 - B2) * (g[p] ** 2) + B2 * v for p, v in state["nu"].items()}
        bc1 = np.float32(1) - np.float32(B1) ** np.float32(t)
        bc2 = np.float32(1) - np.float32(B2) ** np.float32(t)
        step = -self.schedule(state["count"])
        updates = {}
        for p in mu:
            u = (mu[p] / _scalar(bc1, mu[p])) / (torch.sqrt(nu[p] / _scalar(bc2, nu[p])) + EPS)
            updates[p] = _scalar(step, u) * u
        return updates, {"count": t, "mu": mu, "nu": nu}


def make_optimizer(
    learning_rate: float = 3e-4,
    total_steps: int = 1000,
    warmup_steps: int = 100,
    accum_steps: int = 1,
    mask: Optional[Params] = None,
) -> Optimizer:
    """AdamW with HF Trainer's default linear warmup and decay, masked, with
    accumulation; the Trainer's implicit clip at :data:`MAX_GRAD_NORM` is
    taken over the trainable leaves alone."""
    return Optimizer(make_schedule(learning_rate, total_steps, warmup_steps), mask=mask,
                     accum_steps=accum_steps)


# ---------------------------------------------------------------------------
# Train steps
# ---------------------------------------------------------------------------


def _value_and_grad(loss_fn: Callable, tree, paths: List[str]) -> Tuple[torch.Tensor, Grads]:
    """``loss_fn(tree)`` and its gradients with respect to the leaves at
    ``paths`` alone (every other leaf is detached and takes no gradient)."""
    wanted = set(paths)
    leaves: Dict[str, torch.Tensor] = {}

    def leaf(p, x):
        x = x.detach()
        if p in wanted:
            leaves[p] = x.requires_grad_()
        return x

    tree = _with_leaves(tree, leaf)
    with torch.enable_grad():
        loss = loss_fn(tree)
        grads = torch.autograd.grad(loss, [leaves[p] for p in paths])
    return loss.detach(), dict(zip(paths, grads))


def _subtree_split(params: Params, redundant: Tuple[int, ...]):
    """(trainable subtree {str(li): layer}, merge_fn) for the redundant layers."""

    def merge(tr, base):
        layers = list(base["layers"])
        for li in redundant:
            layers[li] = tr[str(li)]
        return {**base, "layers": layers}

    return {str(li): params["layers"][li] for li in redundant}, merge


def _make_step(config: ModelConfig, plan: ModelPlan, optimizer: Optimizer, remat: bool,
               accumulate: bool, redundant: Optional[Tuple[int, ...]] = None) -> Callable:
    """One optimizer step: ``step(params, opt_state, input_ids, labels,
    attention_mask) -> (params, opt_state, loss)``. ``accumulate``: the
    inputs are a stacked group [accum, micro_bs, seq], token-weighted: the
    CE sums over shifted positions divided by the group's count of unshifted
    labels, gradients summed in the parameters' dtype and divided in fp32.
    ``redundant``: the optimizer runs over that subtree."""

    def logits(p, ids, am):
        return forward(p, ids, config=config, plan=plan, attention_mask=am, remat=remat)["logits"]

    def step(params, opt_state, input_ids, labels, attention_mask):
        if redundant is None:
            train, merge = params, lambda tr, base: tr
        else:
            train, merge = _subtree_split(params, redundant)
        paths = optimizer.paths(train)
        if not accumulate:
            loss, grads = _value_and_grad(
                lambda tr: hf_causal_lm_loss(logits(merge(tr, params), input_ids, attention_mask),
                                             labels), train, paths)
        else:
            n_items = torch.clamp((labels != -100).sum(), min=1).float()
            grads, ce_total = {}, torch.zeros((), dtype=torch.float32, device=labels.device)
            for i in range(input_ids.shape[0]):
                am = None if attention_mask is None else attention_mask[i]
                ce, g = _value_and_grad(
                    lambda tr: hf_causal_lm_loss_sum(logits(merge(tr, params), input_ids[i], am),
                                                     labels[i]), train, paths)
                grads = {p: grads[p] + x for p, x in g.items()} if grads else g
                ce_total = ce_total + ce
            grads = {p: (g.float() / n_items).to(g.dtype) for p, g in grads.items()}
            loss = ce_total / n_items
        updates, opt_state = optimizer.update(grads, opt_state, train)
        return merge(apply_updates(train, updates), params), opt_state, loss

    return step


def make_train_step(config: ModelConfig, plan: ModelPlan, optimizer: Optimizer,
                    remat: bool = False) -> Callable:
    """One step on one batch: (params, opt_state, ids, labels, mask) ->
    (params, opt_state, loss); differentiates the optimizer's trainable
    leaves of the whole tree."""
    return _make_step(config, plan, optimizer, remat, accumulate=False)


def make_accum_train_step(config: ModelConfig, plan: ModelPlan, optimizer: Optimizer,
                          remat: bool = False) -> Callable:
    """One optimizer step over a STACKED group of micro-batches [accum,
    micro_bs, seq], token-weighted exactly like HF Trainer (>= 4.46):
    loss = sum over micros of CE_sum(micro) / num_items_in_batch, where
    ``num_items_in_batch`` counts *unshifted* labels != -100 across the whole
    group while the CE sums run over shifted positions."""
    return _make_step(config, plan, optimizer, remat, accumulate=True)


def make_subtree_train_step(config: ModelConfig, plan: ModelPlan, optimizer: Optimizer,
                            redundant_layers: List[int], remat: bool = False) -> Callable:
    """make_train_step with the optimizer over the redundant layers' subtree:
    build it without a mask and initialize it with
    ``optimizer.init({str(li): params['layers'][li] for li in redundant})``.
    Its updates equal make_train_step's on the trainable leaves."""
    redundant = tuple(sorted({int(i) for i in redundant_layers}))
    return _make_step(config, plan, optimizer, remat, accumulate=False, redundant=redundant)


def make_subtree_accum_train_step(config: ModelConfig, plan: ModelPlan, optimizer: Optimizer,
                                  redundant_layers: List[int], remat: bool = False) -> Callable:
    """make_accum_train_step over the redundant layers' subtree."""
    redundant = tuple(sorted({int(i) for i in redundant_layers}))
    return _make_step(config, plan, optimizer, remat, accumulate=True, redundant=redundant)


def stack_micro_batches(
    group: List[Dict[str, Any]], pad_token_id: int = 0
) -> Dict[str, Optional[np.ndarray]]:
    """Stack micro-batches into [accum, micro_bs, seq], right-padding each to
    the group's max seq len (input_ids -> pad_token_id, labels -> -100,
    attention_mask -> 0). Right padding is loss-invariant under the causal
    mask + -100 labels, so the group computes exactly what HF computes on the
    unpadded micros."""
    max_len = max(int(np.asarray(b["input_ids"]).shape[1]) for b in group)
    any_mask = any(b.get("attention_mask") is not None for b in group)

    def pad(x, value):
        x = np.asarray(x)
        if x.shape[1] == max_len:
            return x
        return np.pad(x, ((0, 0), (0, max_len - x.shape[1])), constant_values=value)

    ids = np.stack([pad(b["input_ids"], pad_token_id) for b in group])
    labels = np.stack([pad(b["labels"], -100) for b in group])
    mask = None
    if any_mask:
        mask = np.stack([
            pad(
                b["attention_mask"]
                if b.get("attention_mask") is not None
                else np.ones_like(np.asarray(b["input_ids"])),
                0,
            )
            for b in group
        ])
    return {"input_ids": ids, "labels": labels, "attention_mask": mask}


def make_eval_step(config: ModelConfig, plan: ModelPlan) -> Callable:
    def step(params, input_ids, labels, attention_mask):
        with torch.no_grad():
            logits = forward(params, input_ids, config=config, plan=plan,
                             attention_mask=attention_mask)["logits"]
            return hf_causal_lm_loss(logits, labels)

    return step


# ---------------------------------------------------------------------------
# Train-state checkpointing (reference alpaca_grasp.py:143-153, 184-188)
# ---------------------------------------------------------------------------


def save_train_state(
    output_dir: str, step: int, params: Params, opt_state, history: Dict[str, Any],
    save_total_limit: int = 3, opt_step: Optional[int] = None,
) -> str:
    """Save params and optimizer state (``step_N/state.pt``, one
    ``torch.save``) and {step, opt_step, history} (``train_meta.json``) under
    output_dir/step_N, pruning to the newest ``save_total_limit``
    checkpoints (HF Trainer semantics, alpaca_grasp.py:187).

    opt_step: the optimizer-step counter at save time, so that a resumed
    token-weighted run keeps the eval/save/log cadence even when epoch-tail
    flushes made partial groups."""
    path = os.path.abspath(os.path.join(output_dir, f"step_{step}"))
    os.makedirs(path, exist_ok=True)
    detach = lambda x: x.detach().contiguous() if torch.is_tensor(x) else x  # noqa: E731
    torch.save({"params": {k: detach(v) for k, v in flatten_params(params).items()},
                "opt": map_params(opt_state, detach)}, os.path.join(path, "state.pt"))
    with open(os.path.join(path, "train_meta.json"), "w") as f:
        json.dump({"step": step, "opt_step": opt_step, "history": history}, f)

    kept = sorted(
        (d for d in os.listdir(output_dir) if d.startswith("step_")),
        key=lambda d: int(d.split("_")[1]),
    )
    for stale in kept[:-save_total_limit] if save_total_limit else []:
        shutil.rmtree(os.path.join(output_dir, stale), ignore_errors=True)
    return path


def _like(saved, template, where: str = "opt"):
    """``saved`` with every tensor cast to the template's dtype and device;
    raises ValueError where the two trees differ."""
    if isinstance(template, dict):
        if not isinstance(saved, dict) or set(saved) != set(template):
            raise ValueError(f"the saved optimizer state differs from this optimizer's at "
                             f"{where} (saved with another grad_scope or accumulation?)")
        return {k: _like(saved[k], template[k], f"{where}.{k}") for k in template}
    if torch.is_tensor(template):
        return saved.to(device=template.device, dtype=template.dtype)
    return type(template)(saved)


def load_train_state(path: str, opt_state_template,
                     device=None) -> Tuple[Params, Any, int, Dict[str, Any]]:
    """Restore (params, opt_state, step, history) saved by save_train_state.

    opt_state_template: a freshly initialized optimizer state; the saved one
    must have its structure, and takes its dtypes and device. ``device``:
    where the params go (default: the template's device)."""
    path = os.path.abspath(path)
    if device is None:
        tensors = [x for _, x in _leaf_paths(opt_state_template) if torch.is_tensor(x)]
        device = tensors[0].device if tensors else "cpu"
    state = torch.load(os.path.join(path, "state.pt"), map_location=device, weights_only=True)
    meta = load_train_meta(path)
    opt_state = _like(state["opt"], opt_state_template)
    return unflatten_params(state["params"]), opt_state, int(meta["step"]), meta["history"]


def load_train_meta(path: str) -> Dict[str, Any]:
    """The step/opt_step/history metadata saved alongside a train state."""
    with open(os.path.join(os.path.abspath(path), "train_meta.json")) as f:
        return json.load(f)


def latest_checkpoint(output_dir: str) -> Optional[str]:
    if not os.path.isdir(output_dir):
        return None
    steps = sorted(
        (d for d in os.listdir(output_dir) if d.startswith("step_")),
        key=lambda d: int(d.split("_")[1]),
    )
    return os.path.join(output_dir, steps[-1]) if steps else None


def recovery_train(
    params: Params,
    config: ModelConfig,
    plan: ModelPlan,
    redundant_layers: List[int],
    train_batches: Iterable[Dict[str, np.ndarray]],
    val_batches: Optional[List[Dict[str, np.ndarray]]] = None,
    num_epochs: int = 1,
    learning_rate: float = 3e-4,
    accum_steps: int = 1,
    accum_mode: str = "token_weighted",
    warmup_steps: int = 100,
    steps_per_epoch: Optional[int] = None,
    eval_every: int = 200,
    log_every: int = 10,
    remat: bool = False,
    mesh=None,
    output_dir: Optional[str] = None,
    save_total_limit: int = 3,
    resume_from_checkpoint: Optional[str] = None,
    load_best_at_end: bool = True,
    grad_scope: str = "full",
) -> Tuple[Params, Dict[str, Any]]:
    """Run GRASP* recovery training on the params' device; returns
    (new_params, history).

    train_batches: iterable of numpy {"input_ids", "labels",
    "attention_mask"} (labels -100 where masked; the loss shifts internally
    as HF does). accum_mode "token_weighted" (the default) stacks each group
    and divides by its label-token count (HF Trainer >= 4.46); "mean" keeps
    optax.MultiSteps' running mean of the per-micro mean losses (equal when
    every micro-batch carries the same token count). grad_scope "full" or
    "layers": the same updates; checkpoints are scope-specific (the
    optimizer state's keys differ), so resume with the scope that saved.

    When output_dir is set: eval + save every ``eval_every`` optimizer steps
    (micro-steps // accum_steps, HF's global_step), keep the newest
    ``save_total_limit``, and, with val_batches, load the checkpoint of the
    lowest eval loss at the end. resume_from_checkpoint (a step_N dir, or an
    output_dir whose latest step is taken) restores params, optimizer state
    and step, and fast-forwards the data stream.
    """
    if mesh is not None:
        raise NotImplementedError("grasp_tpu_torch does not support recovery on a mesh yet")
    dev = params["embed_tokens"]["weight"].device
    mask = trainable_mask(params, redundant_layers)
    total, trainable = count_trainable(params, mask)
    logger.info(
        "trainable params: %d || all params: %d || trainable: %.2f%%",
        trainable, total, 100.0 * trainable / total,
    )

    if steps_per_epoch is None:
        try:
            steps_per_epoch = len(train_batches)  # type: ignore[arg-type]
        except TypeError:
            steps_per_epoch = 1000
    total_steps = max(1, (steps_per_epoch * num_epochs) // max(accum_steps, 1))

    if accum_mode not in ("token_weighted", "mean"):
        raise ValueError(f"accum_mode must be token_weighted|mean, got {accum_mode!r}")
    token_weighted = accum_mode == "token_weighted" and accum_steps > 1

    if grad_scope not in ("full", "layers"):
        raise ValueError(f"grad_scope must be full|layers, got {grad_scope!r}")
    optimizer = make_optimizer(
        learning_rate=learning_rate,
        total_steps=total_steps,
        warmup_steps=min(warmup_steps, total_steps),
        accum_steps=1 if token_weighted else accum_steps,
        mask=None if grad_scope == "layers" else mask,
    )
    if grad_scope == "layers":
        redundant = tuple(sorted({int(i) for i in redundant_layers}))
        opt_state = optimizer.init(_subtree_split(params, redundant)[0])
        train_step = _make_step(config, plan, optimizer, remat, token_weighted, redundant)
    else:
        opt_state = optimizer.init(params)
        train_step = _make_step(config, plan, optimizer, remat, token_weighted)
    eval_step = make_eval_step(config, plan) if val_batches else None

    history: Dict[str, Any] = {"train_loss": [], "eval_loss": []}
    start_step = 0
    if resume_from_checkpoint:
        ckpt = resume_from_checkpoint
        if not os.path.basename(ckpt).startswith("step_"):
            found = latest_checkpoint(ckpt)
            if found is None:
                raise FileNotFoundError(f"no step_N checkpoints under {ckpt!r}")
            ckpt = found
        params, opt_state, start_step, history = load_train_state(ckpt, opt_state, device=dev)
        resumed_opt_step = load_train_meta(ckpt).get("opt_step")
        logger.info("resumed from %s at micro-step %d", ckpt, start_step)

    def _prep(b):
        return {k: None if b.get(k) is None else torch.as_tensor(np.asarray(b[k]), device=dev)
                for k in ("input_ids", "labels", "attention_mask")}

    def _run_eval(p):
        return float(np.mean([
            float(eval_step(p, b["input_ids"], b["labels"], b["attention_mask"]))
            for b in map(_prep, val_batches)
        ]))

    best = (float("inf"), None)  # (eval loss, checkpoint path)
    step_i = 0
    # Optimizer-step counter: restored from the checkpoint when present; the
    # floor-division fallback (checkpoints without it) assumes every earlier
    # group was full and can drift the cadence across an epoch tail.
    opt_i = start_step // max(accum_steps, 1)
    if resume_from_checkpoint and resumed_opt_step is not None:
        opt_i = int(resumed_opt_step)
    t0 = time.time()
    group: List[Dict[str, Any]] = []

    def _eval_and_save():
        nonlocal best
        ev = None
        if eval_step:
            ev = _run_eval(params)
            history["eval_loss"].append((step_i, ev))
            logger.info("eval loss %.4f", ev)
        if output_dir:
            path = save_train_state(
                output_dir, step_i, params, opt_state, history,
                save_total_limit=save_total_limit, opt_step=opt_i,
            )
            if eval_step and ev < best[0]:
                best = (ev, path)

    def _flush_group(epoch):
        nonlocal params, opt_state, opt_i, group
        arrs = _prep(stack_micro_batches(group))
        group = []
        params, opt_state, loss = train_step(
            params, opt_state, arrs["input_ids"], arrs["labels"], arrs["attention_mask"])
        opt_i += 1
        # log_every counts OPTIMIZER steps here (HF logging_steps)
        if opt_i % log_every == 0:
            lv = float(loss)
            history["train_loss"].append((step_i, lv))
            logger.info("epoch %d opt-step %d loss %.4f (%.1fs)",
                        epoch, opt_i, lv, time.time() - t0)
        # every eval_every OPTIMIZER steps (HF global_step counts
        # accumulation cycles, alpaca_grasp.py:184-186)
        if opt_i % eval_every == 0:
            _eval_and_save()

    for epoch in range(num_epochs):
        for batch in train_batches:
            step_i += 1
            if step_i <= start_step:
                continue  # fast-forward a resumed run through consumed data
            if token_weighted:
                group.append(batch)
                if len(group) == accum_steps:
                    _flush_group(epoch)
                continue
            batch = _prep(batch)
            params, opt_state, loss = train_step(
                params, opt_state, batch["input_ids"], batch["labels"], batch["attention_mask"])
            if step_i % log_every == 0:
                lv = float(loss)
                history["train_loss"].append((step_i, lv))
                logger.info("epoch %d step %d loss %.4f (%.1fs)", epoch, step_i, lv,
                            time.time() - t0)
            if step_i % max(accum_steps, 1) == 0:
                opt_i = step_i // max(accum_steps, 1)  # keep the saved opt_step honest
                if opt_i % eval_every == 0:
                    _eval_and_save()
        if group:
            # epoch tail: HF's iterator yields a final smaller group and still
            # counts it as one global step
            _flush_group(epoch)

    if output_dir and load_best_at_end and best[1] is not None and os.path.isdir(best[1]):
        final_ev = _run_eval(params) if eval_step else float("inf")
        if best[0] < final_ev:
            logger.info("loading best checkpoint %s (eval %.4f < final %.4f)",
                        best[1], best[0], final_ev)
            params, _, _, _ = load_train_state(best[1], opt_state, device=dev)

    return params, history
