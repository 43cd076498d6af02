"""Parameter conversion between grasp_tpu's pytrees and the port's tensors.

grasp_tpu's parameters become numpy on the JAX side with
``jax.tree.map(np.asarray, params)``; :func:`params_from_numpy` turns that
tree into the port's nested dict of tensors (same keys, same [in, out]
layout). bfloat16 arrays (numpy dtype ``bfloat16`` from ml_dtypes) move bit
for bit. :func:`params_to_numpy` is the inverse, for tests.
:func:`flatten_params` / :func:`unflatten_params` map the nested dict to
dotted keys (``layers.0.self_attn.q_proj.kernel``) for checkpoints.
"""

from __future__ import annotations

from typing import Any, Dict, Optional

import numpy as np
import torch


def _tensor_from_numpy(arr) -> torch.Tensor:
    arr = np.asarray(arr)
    if arr.dtype.name == "bfloat16":
        return torch.from_numpy(np.array(arr.view(np.int16))).view(torch.bfloat16)
    return torch.from_numpy(np.array(arr))


def _tensor_to_numpy(t: torch.Tensor) -> np.ndarray:
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        import ml_dtypes  # present wherever JAX is

        return t.view(torch.int16).numpy().view(ml_dtypes.bfloat16)
    return t.numpy()


def map_params(tree, fn):
    """A new tree (fresh dicts and lists) with ``fn`` applied to every leaf."""
    if isinstance(tree, dict):
        return {k: map_params(v, fn) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [map_params(v, fn) for v in tree]
    return fn(tree)


def params_from_numpy(tree: Any, device, dtype: Optional[torch.dtype] = None) -> Dict[str, Any]:
    """grasp_tpu params as numpy -> port params on ``device``; ``dtype``
    casts the floating weights (None keeps each leaf's own dtype). The leaves
    of a quantized tree keep theirs either way: int8 ``*_q`` / ``*_q4``
    values, and the fp32 ``*_scale`` leaves beside them, which both packages
    multiply in fp32."""
    def convert(node, key=""):
        if isinstance(node, dict):
            return {k: convert(v, k) for k, v in node.items()}
        if isinstance(node, (list, tuple)):
            return [convert(v, key) for v in node]
        t = _tensor_from_numpy(node)
        if dtype is not None and t.is_floating_point() and not key.endswith("_scale"):
            t = t.to(dtype)
        return t.to(device)

    return convert(tree)


def params_to_numpy(params: Dict[str, Any]) -> Dict[str, Any]:
    """Port params -> the numpy tree grasp_tpu takes (bf16 as ml_dtypes)."""
    return map_params(params, _tensor_to_numpy)


def flatten_params(params: Dict[str, Any], prefix: str = "") -> Dict[str, torch.Tensor]:
    flat: Dict[str, torch.Tensor] = {}
    items = enumerate(params) if isinstance(params, list) else params.items()
    for k, v in items:
        key = f"{prefix}{k}"
        if isinstance(v, (dict, list)):
            flat.update(flatten_params(v, key + "."))
        else:
            flat[key] = v
    return flat


def unflatten_params(flat: Dict[str, torch.Tensor]) -> Dict[str, Any]:
    """Inverse of :func:`flatten_params`: all-digit path parts become list
    indices (``layers.3`` -> ``params["layers"][3]``)."""
    root: Dict[str, Any] = {}
    for key, value in flat.items():
        node = root
        parts = key.split(".")
        for part in parts[:-1]:
            node = node.setdefault(part, {})
        node[parts[-1]] = value

    def listify(node):
        if not isinstance(node, dict):
            return node
        node = {k: listify(v) for k, v in node.items()}
        if node and all(k.isdigit() for k in node):
            return [node[str(i)] for i in range(len(node))]
        return node

    return listify(root)
