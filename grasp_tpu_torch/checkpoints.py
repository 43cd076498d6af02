"""Checkpoint save/load (counterpart of grasp_tpu/checkpoints.py).

The same ``grasp_meta.json`` schema as grasp_tpu (model config, projection
plan, rank_dict, redundant layers, BI scores), with ``"framework":
"grasp_tpu_torch"``; the parameters are one flat ``torch.save`` file of
tensors under dotted pytree keys, read back with ``weights_only=True``. A
grasp_tpu (Orbax) checkpoint is turned into this format by
``scripts/convert_grasp_tpu_checkpoint.py`` where JAX is installed.
"""

from __future__ import annotations

import json
import os
from typing import Any, Dict, Optional, Tuple

import torch

from grasp_tpu_torch.configs import ModelConfig
from grasp_tpu_torch.models.convert import flatten_params, unflatten_params
from grasp_tpu_torch.models.llama import ModelPlan

META_NAME = "grasp_meta.json"
PARAMS_FILE = "params.pt"
FRAMEWORK = "grasp_tpu_torch"


def save_checkpoint(path: str, params: Any, config: ModelConfig, plan: ModelPlan,
                    rank_dict: Optional[Dict[str, int]] = None,
                    redundant_layers: Optional[list] = None,
                    layer_importances: Optional[list] = None,
                    extra: Optional[Dict[str, Any]] = None,
                    params_file: str = PARAMS_FILE, mesh=None) -> str:
    """Save params + JSON metadata. The meta write is the commit point:
    params go down first (to ``params_file`` in ``path``), then the meta,
    which names that file, is written to a temp file and ``os.replace``d
    into place. A caller that alternates two ``params_file`` names never
    touches the file the committed meta points at.

    mesh: ``params`` are this rank's shards (parallel.mesh.shard_params);
    every rank calls, the whole tree is gathered, rank 0 writes it, and
    every rank returns once it is written: the checkpoint a single process
    with the same params writes."""
    path = os.path.abspath(path)
    if mesh is not None:
        from grasp_tpu_torch.parallel.mesh import gather_params

        params = gather_params(params, mesh, config)
        if mesh.rank == 0:
            save_checkpoint(path, params, config, plan, rank_dict, redundant_layers,
                            layer_importances, extra, params_file)
        mesh.barrier()
        return path
    os.makedirs(path, exist_ok=True)
    flat = {k: v.detach().contiguous() for k, v in flatten_params(params).items()}
    tmp_params = os.path.join(path, params_file + ".tmp")
    with open(tmp_params, "wb") as f:
        torch.save(flat, f)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp_params, os.path.join(path, params_file))

    meta = {
        "framework": FRAMEWORK,
        "model_config": json.loads(config.to_json()),
        "plan": [list(layer) for layer in plan],
        "rank_dict": rank_dict or {},
        "redundant_layers": list(redundant_layers or []),
        "layer_importances": [float(x) for x in (layer_importances or [])],
        "params_file": params_file,
        "extra": extra or {},
    }
    tmp = os.path.join(path, META_NAME + ".tmp")
    with open(tmp, "w") as f:
        json.dump(meta, f, indent=2)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, os.path.join(path, META_NAME))
    return path


def load_checkpoint(path: str, device) -> Tuple[Any, ModelConfig, ModelPlan, Dict[str, Any]]:
    """Returns (params on ``device``, config, plan, meta)."""
    path = os.path.abspath(path)
    with open(os.path.join(path, META_NAME)) as f:
        meta = json.load(f)
    if meta.get("framework") != FRAMEWORK:
        raise NotImplementedError(
            f"{path} is a {meta.get('framework')!r} checkpoint; convert it with "
            "scripts/convert_grasp_tpu_checkpoint.py first")
    config = ModelConfig(**meta["model_config"])
    plan: ModelPlan = tuple(tuple(layer) for layer in meta["plan"])
    flat = torch.load(os.path.join(path, meta["params_file"]), map_location=device,
                      weights_only=True)
    return unflatten_params(flat), config, plan, meta
