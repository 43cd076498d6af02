"""grasp_tpu_torch.perf on the card: a chain captured as one CUDA graph
computes what the same chain computes eagerly, the device benchmarks time
graphs (the flash forward's launches counted at the eager run and the
capture, none at a replay), a chain that waits for the host refuses to be
captured while a longrope chain captures, and device memory follows the
allocator.

Needs an NVIDIA GPU and no JAX; from the repository root:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda_perf.py

Every test is marked ``cuda`` and skips where torch sees no CUDA device.
"""

import pytest
import torch

from grasp_tpu_torch import perf
from grasp_tpu_torch.configs import ModelConfig
from grasp_tpu_torch.models.llama import init_params
from grasp_tpu_torch.ops.flash_attention import flash_attention

pytestmark = pytest.mark.cuda

LAYERS = 2
# a replay against the same chain run eagerly: the same kernels on the same
# inputs; the slack covers a library product that picks another algorithm
# inside a capture
GRAPH_EAGER_RTOL = 1e-3


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda", 0)


def _model(dev, **overrides):
    config = ModelConfig.tiny(vocab_size=512, hidden_size=256, intermediate_size=704,
                              num_attention_heads=4, num_key_value_heads=2,
                              num_hidden_layers=LAYERS, max_position_embeddings=1024,
                              dtype="bfloat16", **overrides)
    return config, init_params(torch.Generator(device=dev).manual_seed(0), config, device=dev)


def test_graphs_time_the_chains_and_compute_what_eager_computes(dev):
    config, params = _model(dev, use_flash_attention=True)
    chain = perf.decode_chain(params, config, cache_len=128, prefill_len=16, batch=2)
    graph, out = perf.capture_chain(chain, 6)
    graph.replay()
    torch.cuda.synchronize()
    got, want = float(out), float(chain.run(6))
    assert abs(got - want) <= GRAPH_EAGER_RTOL * abs(want)
    res = perf.decode_device_benchmark(params, config, cache_len=128, prefill_len=16,
                                       k_small=4, k_large=12, reps=2, batch=2)
    assert res["decode_ms_per_token_device"] > 0 and res["batch"] == 2

    ids = torch.randint(0, config.vocab_size, (2, 256), device=dev,
                        generator=torch.Generator(device=dev).manual_seed(1))
    flash_attention.launches["fwd"] = 0
    res = perf.forward_device_benchmark(params, config, ids, labels=ids, reps=2)
    assert res["fwd_s_device"] > 0
    # one eager forward for each of k 1 and 5, then their captures: no replay counts
    assert flash_attention.launches["fwd"] == (2 + 1 + 5) * LAYERS


def test_device_memory_follows_the_allocator(dev):
    x = torch.empty(64 << 20, dtype=torch.uint8, device=dev)
    mem = perf.device_memory()
    assert mem["bytes_in_use"] >= x.numel() and mem["peak_bytes_in_use"] >= mem["bytes_in_use"]
    assert mem["bytes_limit"] == torch.cuda.mem_get_info(dev)[1]
    del x
    perf.reset_hbm_peak()
    after = perf.device_memory(dev)
    assert after["peak_bytes_in_use"] == after["bytes_in_use"] < mem["bytes_in_use"]


def test_a_chain_that_waits_for_the_host_is_not_timed(dev):
    """A decode chain whose every step reads a value back to the host (the
    step's largest logit, with .item()) cannot be captured, and its time is
    refused. Longrope, which used to be the example, picks its factors on
    the device: its chain, across original_max_position_embeddings, captures
    and replays to what it computes eagerly."""
    config, params = _model(dev)
    chain = perf.decode_chain(params, config, cache_len=128, prefill_len=16)

    def run(k):
        out = chain.run(k)
        out.item()  # waits for the host
        return out

    with pytest.raises(RuntimeError, match="could not be captured"):
        perf.chain_seconds(perf.Chain(run, chain.device), [1, 2], reps=1)
    longrope = {"rope_type": "longrope", "original_max_position_embeddings": 20,
                "short_factor": [1.0] * 32, "long_factor": [2.0] * 32}  # head_dim 64
    config, params = _model(dev, rope_scaling=longrope)
    chain = perf.decode_chain(params, config, cache_len=128, prefill_len=16)
    graph, out = perf.capture_chain(chain, 8)  # positions 16 to 23 cross 20
    graph.replay()
    torch.cuda.synchronize()
    got, want = float(out), float(chain.run(8))
    assert abs(got - want) <= GRAPH_EAGER_RTOL * abs(want)
