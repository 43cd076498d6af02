"""grasp_tpu_torch: the PyTorch/CUDA port of grasp_tpu, for NVIDIA Hopper.

The JAX package ``grasp_tpu`` stays the reference; this package mirrors its
module paths (``models.llama``, ``core.engine``, ``serving.paged``, ...) so
each counterpart is found by name. It imports ``torch``, never ``jax`` and
nothing of ``grasp_tpu``: ``configs`` (re-exported here) and
``data.tokenizer`` are the port's own copies of the reference's two JAX-free
modules.

Ported so far: the compression pipeline (block influence, SVD, calibration
gradient sweeps, rank selection, low-rank compilation; sequential or parallel
sweeps, the prefix split, resume snapshots, remat, the gram SVDs;
``grasp-compress-torch``) with causal flash attention forward and backward in hand-written CUDA kernels
(``csrc/flash_attention.cu``), and serving a LLaMA-family model (dense and
GRASP low-rank projections) over a paged KV cache with decode attention in a
hand-written CUDA kernel (``csrc/paged_attention.cu``; ``grasp-serve-torch``),
for every model family of the JAX package (LLaMA, Qwen2, Phi-3, Mistral,
Gemma, Gemma-2, Mixtral), and a ``("data", "model")`` device mesh
(``parallel``: ``--dp``/``--tp``, recovery, tensor- and expert-parallel
serving, int4 weights and the fused low-rank kernel on it), the GPipe
pipeline with its ``hybrid`` projection kind, sequence parallelism and ring
attention; and ``perf`` (parameter and FLOP counts, device memory, profiler
traces, generation throughput, and decode and forward times of one CUDA
graph), imported as ``grasp_tpu_torch.perf`` as the JAX package's is.
"""

from grasp_tpu_torch.configs import GraspConfig, ModelConfig  # noqa: F401

__version__ = "0.1.0"
