"""grasp_tpu_torch: the PyTorch/CUDA port of grasp_tpu, for NVIDIA Hopper.

The JAX package ``grasp_tpu`` stays the reference; this package mirrors its
module paths (``models.llama``, ``serving.paged``, ...) so each counterpart is
found by name. It imports ``torch`` and never ``jax``. The two JAX-free modules
of the reference are reused, not copied: ``grasp_tpu.configs`` (re-exported
here) and ``grasp_tpu.data.tokenizer``.

Ported so far: serving a LLaMA-family model (dense and GRASP low-rank
projections) over a paged KV cache, with decode attention in a hand-written
CUDA kernel (``csrc/paged_attention.cu``). Features outside that slice raise
``NotImplementedError``.
"""

from grasp_tpu.configs import GraspConfig, ModelConfig  # noqa: F401

__version__ = "0.1.0"
