"""Multi-device runs on torch.distributed (counterpart of grasp_tpu/parallel).

The device mesh (:mod:`.mesh`) and its launcher (:mod:`.launch`); the
pipeline, sequence parallelism and ring attention are not ported yet
(ROADMAP.md, P10b)."""

from grasp_tpu_torch.parallel.launch import launch  # noqa: F401
from grasp_tpu_torch.parallel.mesh import (  # noqa: F401
    Mesh,
    batch_spec,
    distributed_init,
    gather_params,
    make_mesh,
    param_specs,
    replicate,
    shard_batch,
    shard_params,
)
