"""Model families of the port (counterpart of grasp_tpu.models)."""

from grasp_tpu_torch.models.moe import (  # noqa: F401
    init_moe_params,
    moe_apply,
    router_weights,
)
