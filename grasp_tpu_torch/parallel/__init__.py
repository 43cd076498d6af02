"""Multi-device runs on torch.distributed (counterpart of grasp_tpu/parallel).

The device mesh (:mod:`.mesh`) and its launcher (:mod:`.launch`), ring
attention (:mod:`.ring_attention`), sequence parallelism
(:mod:`.seq_parallel`) and the GPipe pipeline (:mod:`.pipeline`). The last
two import the model, which imports :mod:`.mesh`: their names load on first
use."""

import importlib

from grasp_tpu_torch.parallel.launch import launch  # noqa: F401
from grasp_tpu_torch.parallel.mesh import (  # noqa: F401
    Mesh,
    batch_spec,
    distributed_init,
    gather_params,
    make_mesh,
    param_specs,
    ppermute,
    replicate,
    shard_batch,
    shard_params,
)
from grasp_tpu_torch.parallel.ring_attention import (  # noqa: F401
    context_parallel_attention,
    ring_attention,
)

_LAZY = {
    "make_seq_parallel_train_step": "seq_parallel",
    "seq_parallel_logits": "seq_parallel",
    "seq_parallel_loss": "seq_parallel",
    "dehybridize_layers": "pipeline",
    "from_pipeline_params": "pipeline",
    "hybrid_grad_mask": "pipeline",
    "hybridize_layers": "pipeline",
    "make_pipeline_loss": "pipeline",
    "make_pp_train_step": "pipeline",
    "shard_pipeline_params": "pipeline",
    "to_pipeline_params": "pipeline",
    "uniform_layer_plan": "pipeline",
}


def __getattr__(name):
    if name in _LAZY:
        return getattr(importlib.import_module(f"{__name__}.{_LAZY[name]}"), name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


def __dir__():
    return sorted(set(globals()) | set(_LAZY))
