"""Recovery training on the card through the kernel the JAX package routes it
to: a small bf16 model whose layer 1 is low-rank and trainable, one training
step with ``use_pallas_lowrank`` (the fused low-rank kernel's forward, one
launch a low-rank projection of a forward of 256 rows or more; its backward
is plain products) against plain products, and the launch counts of one
micro-batch with and without ``remat``.

Needs an NVIDIA GPU and no JAX; from the repository root:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda_recover.py

Every test is marked ``cuda`` and skips where torch sees no CUDA device.
"""

import dataclasses

import pytest
import torch

from grasp_tpu_torch.configs import ModelConfig
from grasp_tpu_torch.models.llama import (ATTN_PROJS, PROJ_ORDER, default_plan, forward,
                                          hf_causal_lm_loss, init_params, plan_set)
from grasp_tpu_torch.ops.flash_attention import flash_attention
from grasp_tpu_torch.ops.lowrank import fused_lowrank
from grasp_tpu_torch.train import recover

pytestmark = pytest.mark.cuda

LAYERS, RANK, LOWRANK_LAYER = 3, 40, 1
LOSS_TOL = 2e-2  # bf16 loss, kernel against plain products (chip_smoke.TOL)
GRAD_RTOL = 1e-2  # a gradient's max abs error over the plain one's max (K2's backward gate)


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


def _batch(dev, rows=2, seq=256):
    gen = torch.Generator(device=dev).manual_seed(1)
    ids = torch.randint(1, 512, (rows, seq), generator=gen, device=dev)
    labels = ids.clone()
    labels[:, :40] = -100
    mask = torch.ones_like(ids)
    mask[1, 200:], labels[1, 200:] = 0, -100
    return ids, labels, mask


def _zero_counts():
    for k in flash_attention.launches:
        flash_attention.launches[k] = 0
    fused_lowrank.launches = 0


def test_training_step_through_the_fused_kernel_matches_plain(dev):
    """The loss and every trainable gradient of one micro-batch, then one
    optimizer step, with the kernel against plain products."""
    config, params, plan = _model(dev)
    fused = dataclasses.replace(config, use_pallas_lowrank=True)
    ids, labels, mask = _batch(dev)
    paths = [p for p, _ in recover._leaf_paths(params) if p.startswith(f"layers.{LOWRANK_LAYER}.")]
    got = {}
    for name, cfg in (("plain", config), ("fused", fused)):
        _zero_counts()
        got[name] = recover._value_and_grad(
            lambda p, cfg=cfg: hf_causal_lm_loss(forward(p, ids, config=cfg, plan=plan,
                                                         attention_mask=mask)["logits"], labels),
            params, paths)
        assert fused_lowrank.launches == (7 if name == "fused" else 0), name
    (loss, grads), (want_loss, want) = got["fused"], got["plain"]
    assert abs(loss.item() - want_loss.item()) <= LOSS_TOL and torch.isfinite(loss)
    for p in paths:
        err = (grads[p].float() - want[p].float()).abs().max().item()
        assert err <= GRAD_RTOL * want[p].float().abs().max().item(), p
        assert grads[p].dtype == torch.bfloat16
    steps = {}
    for name, cfg in (("plain", config), ("fused", fused)):
        # lr 1e-2: an update below half the bf16 ulp of 1.0 would leave the
        # norm weights where they are
        opt = recover.make_optimizer(1e-2, total_steps=4, warmup_steps=0,
                                     mask=recover.trainable_mask(params, [LOWRANK_LAYER]))
        step = recover.make_train_step(cfg, plan, opt)
        steps[name] = step(params, opt.init(params), ids, labels, mask)
    new, _, loss = steps["fused"]
    assert abs(loss.item() - steps["plain"][2].item()) <= LOSS_TOL
    frozen = dict(recover._leaf_paths(params))
    for p, leaf in recover._leaf_paths(new):
        assert torch.equal(leaf, frozen[p]) != (p in paths), p


@pytest.mark.parametrize("remat", [False, True])
def test_launch_counts_of_one_micro_batch(dev, remat):
    """One low-rank layer: 7 kernel launches a forward of 512 rows, 7 more
    under remat (the trainable layer's forward recomputed in the backward;
    the frozen layers below it are not); none below 256 rows; no flash
    launch, as the batch carries an attention mask."""
    config, params, plan = _model(dev)
    cfg = dataclasses.replace(config, use_pallas_lowrank=True, use_flash_attention=True)
    opt = recover.make_optimizer(1e-3, total_steps=4, warmup_steps=0,
                                 mask=recover.trainable_mask(params, [LOWRANK_LAYER]))
    step = recover.make_accum_train_step(cfg, plan, opt, remat=remat)
    ids, labels, mask = _batch(dev)
    _zero_counts()
    _, _, loss = step(params, opt.init(params), ids[None], labels[None], mask[None])
    torch.cuda.synchronize()
    assert torch.isfinite(loss)
    assert fused_lowrank.launches == (14 if remat else 7)
    assert flash_attention.launches == {"fwd": 0, "dkv": 0, "dq": 0}
    _zero_counts()
    short = [t[:, :127][None] for t in (ids, labels, mask)]  # 254 rows
    step(params, opt.init(params), *short)
    assert fused_lowrank.launches == 0
