"""grasp_tpu_torch.perf against grasp_tpu.perf on the CPU.

The same weights (made by grasp_tpu, moved over with models.convert) give
the same parameter and FLOP counts in every projection form, exactly (every
term is an integer product, summed in the same order); generation gives
JAX's keys and token count; the device benchmarks give JAX's key sets (the
JAX timers' fori_loops are slow to compile on the CPU, so their keys are
pinned here from grasp_tpu/perf.py); the trace names PyTorch's operators.
"""

import glob
import os

import jax
import numpy as np
import pytest
import torch

from grasp_tpu import perf as jperf
from grasp_tpu.configs import ModelConfig
from grasp_tpu.models import init_params
from grasp_tpu.ops.quant import quantize_model_weights
from grasp_tpu_torch import perf
from torch_parity import grasp_compressed, port_config, small_config, to_port
from torch_parity import one_torch_thread  # noqa: F401  (autouse)

MOE_CFG = dict(vocab_size=128, hidden_size=64, intermediate_size=112, num_hidden_layers=3,
               num_attention_heads=4, num_key_value_heads=2, num_local_experts=4,
               num_experts_per_tok=2)
# grasp_tpu/perf.py:393-401 and :474-479
DECODE_KEYS = {"decode_ms_per_token_device", "decode_tokens_per_s_device",
               "decode_tokens_per_s_aggregate", "per_call_overhead_ms", "k_small", "k_large",
               "batch"}
FORWARD_KEYS = {"fwd_s_device", "per_call_overhead_ms", "k_small", "k_large"}
SVD_RANK = 8


def _svd_form(params, layer):
    """``layer``'s projections as full-SVD factors (u [out, r], s [r], vh
    [r, in]) of rank SVD_RANK, random from a seed: the counts read shapes."""
    params = jax.tree.map(np.asarray, params)
    rng = np.random.default_rng(5)
    lp = params["layers"][layer]
    for group in ("self_attn", "mlp"):
        for name, mod in lp[group].items():
            in_f, out_f = mod["kernel"].shape
            lp[group][name] = {"u": rng.standard_normal((out_f, SVD_RANK), np.float32),
                               "s": rng.standard_normal((SVD_RANK,), np.float32),
                               "vh": rng.standard_normal((SVD_RANK, in_f), np.float32)}
    return params


def _form(which):
    """(JAX config, JAX params) of one projection form."""
    if which == "moe":
        config = ModelConfig.tiny(**MOE_CFG)
        return config, init_params(jax.random.PRNGKey(7), config)
    config = small_config()
    if which == "dense":
        return config, init_params(jax.random.PRNGKey(0), config)
    if which == "svd":
        return config, _svd_form(init_params(jax.random.PRNGKey(0), config), 1)
    params, _ = grasp_compressed(config)  # dense layers and one low-rank layer
    if which == "grasp":
        return config, params
    return config, quantize_model_weights(params, bits=8 if which == "int8" else 4)


@pytest.mark.parametrize("which", ["dense", "grasp", "svd", "int8", "int4", "moe"])
def test_counts_equal_jax(which):
    config, jp = _form(which)
    tp = to_port(jp)
    assert perf.count_params(tp) == jperf.count_params(jp)
    for seq_len in (1, 17):
        want = jperf.estimate_forward_flops(jp, config, seq_len=seq_len)
        got = perf.estimate_forward_flops(tp, port_config(config), seq_len=seq_len)
        assert got == want, (seq_len, got, want)
    if which == "grasp":
        dense = jperf.estimate_forward_flops(init_params(jax.random.PRNGKey(0), config), config,
                                             seq_len=17)
        assert got["params"] < dense["params"] and got["flops"] < dense["flops"]


def test_generation_benchmark_matches_jax():
    config = ModelConfig.tiny(num_hidden_layers=2)
    jp = init_params(jax.random.PRNGKey(0), config)
    kw = dict(prompt_len=16, gen_len=8, warmup=1, iters=1)
    want = jperf.generation_benchmark(jp, config, **kw)
    got = perf.generation_benchmark(to_port(jp), port_config(config), **kw)
    assert got.keys() == want.keys()
    assert got["tokens_generated"] == want["tokens_generated"] == 8
    assert got["prompt_len"] == 16 and got["decode_tokens_per_s"] > 0
    # the memory keys come from device_memory, JAX's three keys; a CPU has none
    assert perf.device_memory("cpu").keys() == jperf.device_memory().keys()
    assert got["peak_hbm_gib"] == got["hbm_in_use_gib"] == 0


@pytest.mark.parametrize("which", ["decode", "forward"])
def test_device_benchmarks_give_jax_keys_on_the_cpu(which):
    config = port_config(ModelConfig.tiny(num_hidden_layers=2))
    params = to_port(init_params(jax.random.PRNGKey(0), ModelConfig.tiny(num_hidden_layers=2)))
    ids = torch.from_numpy(np.random.default_rng(1).integers(0, config.vocab_size, (2, 16)))
    if which == "decode":
        res = perf.decode_device_benchmark(params, config, cache_len=64, prefill_len=16,
                                           k_small=2, k_large=4, reps=2, batch=2)
        assert res.keys() == DECODE_KEYS and res["batch"] == 2
        assert res["decode_ms_per_token_device"] > 0 and res["per_call_overhead_ms"] >= 0
        assert abs(res["decode_tokens_per_s_device"] * res["decode_ms_per_token_device"]
                   - 1e3) < 1e-6
        chain = perf.decode_chain(params, config, cache_len=64, prefill_len=16)
        with pytest.raises(ValueError, match="exceed"):
            chain.run(49)
    else:
        res = perf.forward_device_benchmark(params, config, ids, labels=ids, reps=2)
        assert res.keys() == FORWARD_KEYS and res["fwd_s_device"] > 0
        assert (res["k_small"], res["k_large"]) == (1, 5)
        chain = perf.forward_chain(params, config, ids)
    # the chain is the same from call to call, and a CPU takes no CUDA graph
    assert float(chain.run(2)) == float(chain.run(2))
    assert all(t > 0 for t in perf.chain_seconds(chain, (1, 2), reps=1))
    with pytest.raises(ValueError, match="CUDA"):
        perf.chain_seconds(chain, (2,), graph=True)


def test_trace_writes_a_trace_of_pytorch_operators(tmp_path):
    with perf.trace(str(tmp_path)) as log_dir:
        torch.ones(8, 8) @ torch.ones(8, 8)
    assert log_dir == str(tmp_path)
    (path,) = glob.glob(os.path.join(log_dir, "*.pt.trace.json"))
    with open(path) as f:
        assert "aten::mm" in f.read()
