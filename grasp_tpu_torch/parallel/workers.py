"""Per-rank runs that hold a mesh to one process.

Each function here runs on every rank of a mesh through
:func:`grasp_tpu_torch.parallel.launch.launch` (``fn(mesh, ...)``), takes its
inputs as numpy trees and returns numpy results, so that the caller compares
them with a run in one process: the port's CPU mesh tests (against the JAX
package) and ``chip_smoke.py``'s mesh phase (against the port on one rank).
:func:`run_cases` runs several in one launch. ``python -m
grasp_tpu_torch.parallel.workers`` is the two-process ``distributed_init``
check under torchrun's environment (RANK, WORLD_SIZE, MASTER_ADDR,
MASTER_PORT).
"""

from __future__ import annotations

import json
import sys
from typing import Any, Dict, List, Optional, Sequence

import numpy as np
import torch

from grasp_tpu_torch.configs import GraspConfig, ModelConfig
from grasp_tpu_torch.models.convert import flatten_params, params_from_numpy, params_to_numpy
from grasp_tpu_torch.parallel.mesh import (
    Mesh,
    gather_params,
    leaf_spec,
    shard_params,
)


def _config(config_json: str) -> ModelConfig:
    return ModelConfig.from_json(config_json)


def _plan(plan):
    return None if plan is None else tuple(tuple(layer) for layer in plan)


def forward_logits(mesh: Mesh, params_np, config_json: str, ids: np.ndarray, plan=None,
                   quantize_bits: Optional[int] = None) -> Dict[str, Any]:
    """The tensor- or expert-parallel forward's logits (equal on every rank)
    and each sharded leaf's local shape; ``quantize_bits`` quantizes the
    whole tree (ops/quant.py) before it is sharded."""
    from grasp_tpu_torch.models.llama import forward
    from grasp_tpu_torch.ops.quant import quantize_model_weights

    config = _config(config_json)
    params = params_from_numpy(params_np, mesh.device)
    if quantize_bits:
        params = quantize_model_weights(params, bits=quantize_bits)
    local = shard_params(params, mesh, config)
    with torch.no_grad():
        logits = forward(local, torch.as_tensor(ids, device=mesh.device), config=config,
                         plan=_plan(plan), mesh=mesh)["logits"]
    shapes = {p: tuple(t.shape) for p, t in flatten_params(local).items()}
    return {"logits": logits.float().cpu().numpy(), "shapes": shapes}


def engine_run(mesh: Mesh, params_np, config_json: str, batches: List[Dict[str, np.ndarray]],
               grasp_kwargs: Dict[str, Any], svd_method: str = "auto",
               save_path: Optional[str] = None) -> Dict[str, Any]:
    """``GraspEngine(mesh=).run``: layers, ranks, plan, indices and
    importances on every rank, the gathered params on rank 0. With
    ``save_path`` the checkpoint is saved from the mesh, loaded back and
    sharded again (``reloaded``: equal to the engine's shards)."""
    from grasp_tpu_torch.checkpoints import load_checkpoint, save_checkpoint
    from grasp_tpu_torch.core.engine import GraspEngine

    config = _config(config_json)
    engine = GraspEngine(params_from_numpy(params_np, mesh.device), config,
                         svd_method=svd_method, mesh=mesh)
    summary = engine.run(batches, GraspConfig(**grasp_kwargs))
    whole = gather_params(engine.params, mesh, config)
    out: Dict[str, Any] = {
        "redundant_layers": list(engine.redundant_layers), "rank_dict": dict(engine.rank_dict),
        "plan": engine.plan, "indices": {k: np.asarray(v) for k, v in engine.indices_log.items()},
        "importances": dict(engine.importance_log), "prefix": summary["prefix"]}
    if save_path is not None:
        save_checkpoint(save_path, engine.params, config, engine.plan,
                        rank_dict=engine.rank_dict, redundant_layers=engine.redundant_layers,
                        mesh=mesh)
        loaded, _, plan, _ = load_checkpoint(save_path, mesh.device)
        again = flatten_params(shard_params(loaded, mesh, config))
        mine = flatten_params(engine.params)
        out["reloaded"] = (plan == engine.plan and again.keys() == mine.keys()
                           and all(torch.equal(again[k], mine[k]) for k in mine))
    if mesh.rank == 0:
        out["params"] = params_to_numpy(whole)
    return out


def sharded_svd(mesh: Mesh, w: np.ndarray, method: str = "device") -> Dict[str, Any]:
    """``ops.svd.svd`` of a stack spread over the mesh, and unsharded."""
    from grasp_tpu_torch.ops.svd import svd

    t = torch.as_tensor(w, device=mesh.device)
    got = svd(t, method=method, mesh=mesh)
    want = svd(t, method=method)
    return {"equal": all(torch.equal(a, b) for a, b in zip(got, want)),
            "shapes": [tuple(x.shape) for x in got]}


def serve_streams(mesh: Mesh, params_np, config_json: str, plan, prompts: Dict[str, Any],
                  target_np) -> Dict[str, Any]:
    """The serving surface on tensor-parallel params, greedy streams: the
    ``Generator``, the paged engine and the int8 and int4 ``Generator``s on
    the compressed ``params_np`` (its ``plan``); ``SpeculativeGenerator`` and
    the speculative paged engine with the dense ``target_np`` verifying and
    the compressed model drafting, and one sampled row of the latter.
    ``prompts``: each case's prompts (the JAX serving tests' cases)."""
    from grasp_tpu_torch.eval.generate import Generator
    from grasp_tpu_torch.ops.quant import quantize_model_weights
    from grasp_tpu_torch.serving.paged import ServingEngine
    from grasp_tpu_torch.serving.spec_paged import SpeculativeServingEngine
    from grasp_tpu_torch.serving.speculative import SpeculativeGenerator

    config = _config(config_json)
    dev = mesh.device
    model = shard_params(params_from_numpy(params_np, dev), mesh, config)
    target = shard_params(params_from_numpy(target_np, dev), mesh, config)
    plan = _plan(plan)
    out: Dict[str, Any] = {}
    out["greedy"] = Generator(model, config, plan, mesh=mesh).greedy(prompts["greedy"], 6)
    eng = ServingEngine(model, config, plan, device=dev, num_pages=32, page_size=8,
                        max_batch=2, max_pages_per_seq=4, mesh=mesh)
    rids = [eng.submit(p, 4) for p in prompts["paged"]]
    res = eng.run()
    out["paged"] = [res[r] for r in rids]
    out["pool_kv_heads"] = eng.pool.k_pages.shape[1]
    out["speculative"] = SpeculativeGenerator(
        target, config, model, config, draft_plan=plan, gamma=2, device=dev,
        mesh=mesh).greedy(prompts["speculative"], 6)
    q8 = shard_params(quantize_model_weights(params_from_numpy(params_np, dev), bits=8), mesh,
                      config)
    out["quantized"] = Generator(q8, config, plan, mesh=mesh).greedy(prompts["quantized"], 5)
    q4 = shard_params(quantize_model_weights(params_from_numpy(params_np, dev), bits=4), mesh,
                      config)
    out["int4"] = Generator(q4, config, plan, mesh=mesh).greedy(prompts["int4"], 5)
    spec = SpeculativeServingEngine(target, config, model, config, draft_plan=plan, gamma=2,
                                    device=dev, num_pages=64, page_size=8, max_batch=2,
                                    max_pages_per_seq=6, mesh=mesh)
    rids = [spec.submit(p, 5) for p in prompts["spec_paged"]]
    res = spec.run()
    out["spec_paged"] = [res[r] for r in rids]
    s_rid = spec.submit(prompts["spec_paged"][0], 5, temperature=1.0, top_k=8, seed=3)
    out["spec_sampled"] = spec.run()[s_rid]
    return out


def recover_run(mesh: Mesh, params_np, config_json: Optional[str], plan, layers: Sequence[int],
                train_batches, val_batches, kwargs: Dict[str, Any],
                resume_kwargs: Optional[Dict[str, Any]] = None,
                dtype: Optional[str] = None) -> Dict[str, Any]:
    """``recovery_train(mesh=)``: the history, the gathered params (rank 0),
    and this rank's replicated leaves (those every model rank holds whole),
    for the caller to hold equal across ranks. ``params_np`` may be a port
    checkpoint's path (its config and plan then taken from it; ``dtype``
    casts its weights). ``resume_kwargs``: a second run with these
    overrides (a resume from the first run's checkpoints)."""
    import dataclasses

    from grasp_tpu_torch.checkpoints import load_checkpoint
    from grasp_tpu_torch.models.convert import map_params
    from grasp_tpu_torch.train.recover import recovery_train

    if isinstance(params_np, str):
        params, config, plan, _ = load_checkpoint(params_np, mesh.device)
        if dtype is not None:
            params = map_params(params, lambda t: t.to(getattr(torch, dtype)))
            config = dataclasses.replace(config, dtype=dtype)
    else:
        config = _config(config_json)
        params = params_from_numpy(params_np, mesh.device)
    local, history = recovery_train(params, config, _plan(plan), list(layers), train_batches,
                                    val_batches, mesh=mesh, **kwargs)
    out: Dict[str, Any] = {"history": history, "rank": mesh.rank}
    flat = flatten_params(local)
    out["replicated"] = {p: t.detach().cpu().float().numpy() for p, t in flat.items()
                         if "model" not in leaf_spec(p, t.dim())
                         and p.startswith("layers.") and int(p.split(".")[1]) in layers}
    if resume_kwargs is not None:
        again, history2 = recovery_train(params, config, _plan(plan), list(layers),
                                         train_batches, val_batches, mesh=mesh,
                                         **{**kwargs, **resume_kwargs})
        out["resumed_history"] = history2
        again = flatten_params(again)
        out["resumed_equal"] = all(torch.equal(again[k], v) for k, v in flat.items())
    if not isinstance(params_np, str):
        whole = gather_params(local, mesh, config)
        if mesh.rank == 0:
            out["params"] = params_to_numpy(whole)
    return out


def serve_checkpoint(mesh: Mesh, path: str, prompts: List[List[int]], max_new: int,
                     gamma: int) -> Dict[str, Any]:
    """A port checkpoint served tensor-parallel through the engine API, the
    ranks in lockstep: the plain paged engine, then the speculative one
    with an int8 copy of the weights drafting ``gamma`` tokens. This rank's
    greedy streams, its launches of the paged kernels (decode, chunk) with
    the engines' decode and macro-steps, and each engine's seconds."""
    import time

    from grasp_tpu_torch.checkpoints import load_checkpoint
    from grasp_tpu_torch.ops.paged_attention import paged_attention, paged_attention_chunk
    from grasp_tpu_torch.ops.quant import quantize_model_weights
    from grasp_tpu_torch.serving.paged import ServingEngine
    from grasp_tpu_torch.serving.spec_paged import SpeculativeServingEngine

    params, config, plan, _ = load_checkpoint(path, mesh.device)
    local = shard_params(params, mesh, config)
    draft = shard_params(quantize_model_weights(params, bits=8), mesh, config)
    del params
    kw = dict(device=mesh.device, num_pages=256, page_size=128, max_batch=8,
              max_pages_per_seq=16, mesh=mesh)
    out: Dict[str, Any] = {"rank": mesh.rank}
    for label, engine in (("plain", lambda: ServingEngine(local, config, plan, **kw)),
                          ("speculative", lambda: SpeculativeServingEngine(
                              local, config, draft, config, plan=plan, draft_plan=plan,
                              gamma=gamma, **kw))):
        eng = engine()
        paged_attention.launches = paged_attention_chunk.launches = 0
        t0 = time.perf_counter()
        rids = [eng.submit(p, max_new) for p in prompts]
        with torch.no_grad():
            res = eng.run()
        if mesh.device.type == "cuda":
            torch.cuda.synchronize(mesh.device)
        out[label] = {"streams": [res[r] for r in rids], "seconds": time.perf_counter() - t0,
                      "decode": paged_attention.launches, "chunk": paged_attention_chunk.launches,
                      "decode_steps": eng.decode_steps,
                      "macro_steps": getattr(eng, "macro_steps", 0),
                      "decode_seconds": eng.decode_seconds, "route": eng.route[0],
                      "pool_kv_heads": eng.pool.k_pages.shape[1]}
        del eng
    return out


def _numpy_flat(tree) -> Dict[str, np.ndarray]:
    return {p: t.detach().float().cpu().numpy() for p, t in flatten_params(tree).items()}


def ring_run(mesh: Mesh, q: np.ndarray, k: np.ndarray, v: np.ndarray, causal: bool = True,
             window: Optional[int] = None, softcap: Optional[float] = None,
             dtype: Optional[str] = None) -> Dict[str, Any]:
    """``context_parallel_attention`` of whole q [B, nh, S, hd] and k/v [B,
    nkv, S, hd] over the data axis (``dtype``: cast first), whole on every
    rank, as fp32."""
    from grasp_tpu_torch.parallel.ring_attention import context_parallel_attention

    dt = getattr(torch, dtype) if dtype else None
    q, k, v = (torch.as_tensor(x, device=mesh.device) for x in (q, k, v))
    if dt is not None:
        q, k, v = q.to(dt), k.to(dt), v.to(dt)
    with torch.no_grad():
        out = context_parallel_attention(q, k, v, mesh, causal=causal,
                                         num_kv_groups=q.shape[1] // k.shape[1], window=window,
                                         softcap=softcap)
    return {"out": out.float().cpu().numpy()}


def seq_parallel_run(mesh: Mesh, params_np, config_json: str, ids: np.ndarray, plan=None,
                     labels: Optional[np.ndarray] = None, grads: bool = False,
                     remat: bool = False, train_steps: int = 0, learning_rate: float = 5e-3,
                     dtype: Optional[str] = None) -> Dict[str, Any]:
    """Sequence parallelism over the data axis: the logits of ``ids`` (whole
    on every rank); with ``grads`` the loss against ``labels`` and the
    gradients of every leaf (rank 0); with ``train_steps`` that many steps
    of ``make_seq_parallel_train_step`` with ``optax.adam(learning_rate)``
    (``train.recover.Optimizer``, no clip), their losses and the params
    after them (rank 0)."""
    import dataclasses

    from grasp_tpu_torch.parallel.seq_parallel import (make_seq_parallel_train_step,
                                                       seq_parallel_logits, seq_parallel_loss)
    from grasp_tpu_torch.train.recover import Optimizer, _leaf_paths, _value_and_grad

    config = _config(config_json)
    if dtype is not None:
        config = dataclasses.replace(config, dtype=dtype)
    params = params_from_numpy(params_np, mesh.device,
                               None if dtype is None else getattr(torch, dtype))
    plan = _plan(plan)
    ids_t = torch.as_tensor(ids, device=mesh.device)
    out: Dict[str, Any] = {}
    with torch.no_grad():
        out["logits"] = seq_parallel_logits(params, ids_t, mesh, config, plan).float().cpu().numpy()
    if labels is not None:
        lab = torch.as_tensor(labels, device=mesh.device)
        if grads:
            loss, g = _value_and_grad(
                lambda tree: seq_parallel_loss(tree, ids_t, lab, mesh, config, plan,
                                               remat=remat),
                params, [p for p, _ in _leaf_paths(params)])
            out["loss"] = float(loss)
            if mesh.rank == 0:
                out["grads"] = {p: t.float().cpu().numpy() for p, t in g.items()}
        if train_steps:
            opt = Optimizer(lambda _: np.float32(learning_rate), clip=None)
            step = make_seq_parallel_train_step(config, plan, opt, mesh, remat=remat)
            state, p, losses = opt.init(params), params, []
            for _ in range(train_steps):
                p, state, loss = step(p, state, ids_t, lab)
                losses.append(float(loss))
            out["losses"] = losses
            if mesh.rank == 0:
                out["params"] = _numpy_flat(p)
    return out


def pipeline_run(mesh: Mesh, params_np, config_json: str, ids: np.ndarray, labels: np.ndarray,
                 plan=None, microbatches: int = 4, remat: bool = False, hybrid: bool = False,
                 grads: bool = False, steps: Sequence[tuple] = (), learning_rate: float = 1e-3,
                 weight_decay: float = 1e-4, dtype: Optional[str] = None) -> Dict[str, Any]:
    """The GPipe pipeline on a "pipe" mesh: the params laid out in stages
    (``hybrid``: ``hybridize_layers`` first), the loss; with ``grads`` this
    rank's gradients (its stage, the replicated leaves); with ``steps`` (ids,
    labels of each) ``make_pp_train_step`` with ``optax.adamw(learning_rate)``
    (weight decay ``weight_decay``, no clip; a hybrid plan's
    ``hybrid_grad_mask``), the losses and this rank's params after them.
    Flat numpy trees keyed by path; the fused low-rank kernel's launches."""
    import dataclasses

    from grasp_tpu_torch.models.llama import plan_from_params
    from grasp_tpu_torch.ops.lowrank import fused_lowrank
    from grasp_tpu_torch.parallel.pipeline import (hybrid_grad_mask, hybridize_layers,
                                                   make_pipeline_loss, make_pp_train_step,
                                                   shard_pipeline_params, to_pipeline_params,
                                                   uniform_layer_plan)
    from grasp_tpu_torch.train.recover import Optimizer

    config = _config(config_json)
    if dtype is not None:
        config = dataclasses.replace(config, dtype=dtype)
    params = params_from_numpy(params_np, mesh.device,
                               None if dtype is None else getattr(torch, dtype))
    plan = _plan(plan) or plan_from_params(params, config)
    n_stages = mesh.shape["pipe"]
    mask = None
    if hybrid:
        params, layer_plan, spec = hybridize_layers(params, plan)
        mask = to_pipeline_params(hybrid_grad_mask(params, spec), n_stages)
    else:
        layer_plan = uniform_layer_plan(plan)
    pp = shard_pipeline_params(to_pipeline_params(params, n_stages), mesh)
    del params
    loss_fn = make_pipeline_loss(config, layer_plan, mesh, microbatches, remat)
    ids_t = torch.as_tensor(ids, device=mesh.device)
    lab_t = torch.as_tensor(labels, device=mesh.device)
    out: Dict[str, Any] = {"layer_plan": layer_plan, "stage": mesh.axis_index("pipe")}
    fused_lowrank.launches = 0
    out["loss"] = float(loss_fn(pp, ids_t, lab_t))
    out["launches"] = {"loss": fused_lowrank.launches}
    if grads:
        fused_lowrank.launches = 0
        loss, g = loss_fn.value_and_grad(pp, ids_t, lab_t)
        out["launches"]["grads"] = fused_lowrank.launches
        out["grad_loss"] = float(loss)
        out["grads"] = _numpy_flat(g)
    if steps:
        opt = Optimizer(lambda _: np.float32(learning_rate), clip=None,
                        weight_decay=weight_decay)
        step = make_pp_train_step(config, layer_plan, opt, mesh, microbatches, remat,
                                  grad_mask=mask)
        state, losses = opt.init(pp), []
        for s_ids, s_lab in steps:
            pp, state, loss = step(pp, state, torch.as_tensor(s_ids, device=mesh.device),
                                   torch.as_tensor(s_lab, device=mesh.device))
            losses.append(float(loss))
        out["losses"] = losses
        out["params"] = _numpy_flat(pp)
    return out


def stack_stages(parts: Sequence[Dict[str, np.ndarray]], num_layers: int) -> Dict[str, Any]:
    """Every rank's flat pipeline tree (stage order) as one flat tree of the
    plain layout: ``layers.<i>.<path>`` from each ``stages.<path>``, the
    replicated leaves from the first part."""
    out: Dict[str, Any] = {}
    for path, x in parts[0].items():
        if not path.startswith("stages."):
            out[path] = x
            continue
        whole = np.concatenate([p[path] for p in parts]).reshape(num_layers, *x.shape[2:])
        for i in range(num_layers):
            out[f"layers.{i}.{path[len('stages.'):]}"] = whole[i]
    return out


def run_cases(mesh: Mesh, cases: Sequence[tuple]) -> Dict[str, Any]:
    """Several runs in one launch: ``cases`` of (name, function name of this
    module, kwargs); {name: result}."""
    this = sys.modules[__name__]
    return {name: getattr(this, fn)(mesh, **kw) for name, fn, kw in cases}


def _multihost() -> None:
    """Two processes joined by ``distributed_init`` from torchrun's
    environment: a collective across them, a 2 x 1 mesh, a stack of SVDs
    spread over both against one process's, a batch's rows over the data
    axis and a tensor replicated from rank 0; rank 0 prints one JSON line."""
    from grasp_tpu_torch.ops.svd import svd
    from grasp_tpu_torch.parallel.mesh import (distributed_init, make_mesh, replicate,
                                               shard_batch)

    torch.set_num_threads(1)
    dev, reason = distributed_init(device="cpu", timeout_s=60)
    import torch.distributed as dist

    mesh = make_mesh((dist.get_world_size(), 1), device=dev, timeout_s=60)
    x = torch.full((2,), float(mesh.rank + 1))
    mesh.all_reduce(x)
    w = torch.as_tensor(np.random.default_rng(0).normal(size=(5, 12, 8)).astype(np.float32))
    got, want = svd(w, method="host", mesh=mesh), svd(w, method="host")
    rows = shard_batch({"ids": torch.arange(4)[:, None], "none": None}, mesh)["ids"]
    same = replicate({"x": torch.full((3,), float(mesh.rank))}, mesh)["x"]
    report = {"world": dist.get_world_size(), "rank": mesh.rank, "backend": mesh.backend,
              "reason": reason, "sum": float(x[0]),
              "svd_equal": all(torch.equal(a, b) for a, b in zip(got, want)),
              "rows": rows[:, 0].tolist(), "replicated": same.tolist()}
    if mesh.rank == 0:
        print(json.dumps(report), flush=True)
    dist.destroy_process_group()


if __name__ == "__main__":
    _multihost()
