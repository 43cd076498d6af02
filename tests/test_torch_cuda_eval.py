"""Evaluation on the card through the kernels the JAX package routes it to: a
small bf16 model with one low-rank layer, perplexity windows and harness
batches with ``use_flash_attention`` (flash forward, one launch a layer a
forward) and ``use_pallas_lowrank`` (fused low-rank, one launch a low-rank
projection a forward of 256 rows or more) against the plain route, within
stated tolerances, with the launch counts held.

Needs an NVIDIA GPU and no JAX; from the repository root:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda_eval.py

Every test is marked ``cuda`` and skips where torch sees no CUDA device.
"""

import dataclasses

import numpy as np
import pytest
import torch

from grasp_tpu_torch.configs import ModelConfig
from grasp_tpu_torch.data.tokenizer import ByteTokenizer
from grasp_tpu_torch.eval import harness, ppl
from grasp_tpu_torch.models.llama import (ATTN_PROJS, PROJ_ORDER, default_plan, init_params,
                                          plan_set)
from grasp_tpu_torch.ops.flash_attention import flash_attention
from grasp_tpu_torch.ops.lowrank import fused_lowrank

pytestmark = pytest.mark.cuda

LAYERS, RANK, LOWRANK_LAYER = 3, 40, 1
# a window's mean cross entropy (nats) and a request's summed log-likelihood
# (relative) of a kernel route against the plain route, both in bf16: the
# routes differ in summation order and where they round to bf16
CE_TOL = 1e-2
LL_RTOL = 1e-2


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda", 0)


def _model(dev):
    """bf16, head_dim 64, gqa 2; layer 1's projections low-rank by a
    truncated SVD of their random weights."""
    config = ModelConfig.tiny(vocab_size=512, hidden_size=256, intermediate_size=704,
                              num_attention_heads=4, num_key_value_heads=2,
                              num_hidden_layers=LAYERS, max_position_embeddings=1024,
                              dtype="bfloat16")
    params = init_params(torch.Generator(device=dev).manual_seed(0), config, device=dev)
    plan = default_plan(config)
    for proj in PROJ_ORDER:
        group = params["layers"][LOWRANK_LAYER]["self_attn" if proj in ATTN_PROJS else "mlp"]
        w = group[proj].pop("kernel").float()
        u, s, vh = torch.linalg.svd(w, full_matrices=False)
        group[proj]["in_kernel"] = (u[:, :RANK] * s[:RANK]).bfloat16().contiguous()
        group[proj]["out_kernel"] = vh[:RANK].bfloat16().contiguous()
        plan = plan_set(plan, LOWRANK_LAYER, proj, "lowrank")
    return config, params, plan


def _routes(config):
    return {"plain": config,
            "flash": dataclasses.replace(config, use_flash_attention=True),
            "fused": dataclasses.replace(config, use_flash_attention=True,
                                         use_pallas_lowrank=True)}


def _zero_counts():
    for k in flash_attention.launches:
        flash_attention.launches[k] = 0
    fused_lowrank.launches = 0


def test_windowed_perplexity_through_the_kernels(dev):
    config, params, plan = _model(dev)
    corpus = np.random.default_rng(1).integers(0, 512, 6 * 512 + 9)
    ces, ppls = {}, {}
    for name, cfg in _routes(config).items():
        _zero_counts()
        ces[name] = ppl.windowed_mean_ce(params, cfg, corpus, plan=plan, seqlen=512)
        ppls[name] = ppl.windowed_perplexity(params, cfg, corpus, plan=plan, seqlen=512)
        torch.cuda.synchronize()
        windows = 2 * 6  # both calls
        want_fwd = 0 if name == "plain" else LAYERS * windows
        want_fused = 7 * windows if name == "fused" else 0
        assert flash_attention.launches == {"fwd": want_fwd, "dkv": 0, "dq": 0}, name
        assert fused_lowrank.launches == want_fused, name
        assert len(ces[name]) == 6 and np.isfinite(ces[name]).all()
        assert ppls[name] == pytest.approx(float(np.exp(ces[name].mean())), rel=1e-12)
    for name in ("flash", "fused"):
        assert np.abs(ces[name] - ces["plain"]).max() <= CE_TOL, name
    _zero_counts()
    assert ppl.windowed_perplexity(params, _routes(config)["fused"], corpus, plan=plan,
                                   seqlen=512, limit=1) == pytest.approx(
        float(np.exp(ces["fused"][:2].mean())), rel=1e-12)
    assert flash_attention.launches["fwd"] == LAYERS * 2


def test_harness_batches_through_the_kernels(dev):
    """Requests scored in batches of 8 rows right-padded to 128 or 256: one
    flash launch a layer a batch; the fused kernel where a batch has 256 rows
    or more."""
    config, params, plan = _model(dev)
    rng = np.random.default_rng(2)
    requests = [("".join(chr(97 + c) for c in rng.integers(0, 26, n)), " tail")
                for n in (5, 20, 100, 140, 30, 7, 60, 200, 90, 10, 15, 120)]
    got = {}
    for name, cfg in _routes(config).items():
        lm = harness.EvalLM(params, cfg, ByteTokenizer(vocab_size=512), plan=plan)
        _zero_counts()
        got[name] = lm.loglikelihood(requests)
        torch.cuda.synchronize()
        batches = 2  # 12 requests, 8 a batch, sorted by length: 8 rows of 128 and 4 of 256
        assert flash_attention.launches["fwd"] == (0 if name == "plain" else LAYERS * batches)
        assert fused_lowrank.launches == (7 * batches if name == "fused" else 0)
    for name in ("flash", "fused"):
        for (ll, _), (want, _) in zip(got[name], got["plain"]):
            assert abs(ll - want) <= LL_RTOL * abs(want), name
