"""grasp_tpu_torch's CUDA kernels against their plain versions, on the card.

Needs an NVIDIA GPU and no JAX; from the repository root:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py tests/test_torch_cuda_quant.py

Every test is marked ``cuda`` and skips where torch sees no CUDA device.
"""

import numpy as np
import pytest
import torch

from grasp_tpu_torch.configs import GraspConfig, ModelConfig
from grasp_tpu_torch.core.engine import GraspEngine
from grasp_tpu_torch.models.convert import params_from_numpy, params_to_numpy
from grasp_tpu_torch.models.llama import forward, init_params
from grasp_tpu_torch.ops.flash_attention import flash_attention, flash_attention_reference
from grasp_tpu_torch.ops.paged_attention import paged_attention, paged_attention_reference
from grasp_tpu_torch.serving.paged import ServingEngine

pytestmark = pytest.mark.cuda

# summation order differs from the plain version (both accumulate in fp32);
# bfloat16 outputs keep ~3 significant digits
TOL = {torch.float32: 1e-4, torch.bfloat16: 2e-2}


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda", 0)


def _case(dev, dtype, b, nh, nkv, hd, ps, pps, num_pages, lengths, seed=0):
    gen = torch.Generator(device=dev).manual_seed(seed)
    q = torch.randn(b, nh, hd, generator=gen, device=dev).to(dtype)
    k = torch.randn(nkv, num_pages, ps, hd, generator=gen, device=dev).to(dtype)
    v = torch.randn(nkv, num_pages, ps, hd, generator=gen, device=dev).to(dtype)
    perm = torch.randperm(num_pages - 1, generator=gen, device=dev)[: b * pps] + 1
    tables = perm.reshape(b, pps).to(torch.int32).contiguous()
    lens = torch.tensor(lengths, dtype=torch.int32, device=dev)
    return q, k, v, lens, tables


def test_kernel_matches_plain(dev):
    """Head dims 64 and 128, group sizes 1 to 16, pages of 8 and 128 slots,
    lengths 1, page +- 1 and full, fp32 and bf16."""
    for hd, nh, nkv in ((64, 32, 4), (64, 4, 2), (64, 8, 8), (64, 16, 1), (128, 32, 8),
                        (128, 8, 1)):
        for ps in (8, 128):
            for dtype in (torch.float32, torch.bfloat16):
                pps = 16
                t_max = pps * ps
                lengths = [1, ps - 1, ps, ps + 1, t_max, t_max - 1]
                q, k, v, lens, tables = _case(dev, dtype, len(lengths), nh, nkv, hd, ps, pps,
                                              len(lengths) * pps + 1, lengths)
                got = paged_attention(q, k, v, lens, tables, hd ** -0.5)
                want = paged_attention_reference(q, k, v, lens, tables, hd ** -0.5)
                torch.cuda.synchronize()
                case = f"hd={hd} nh={nh} nkv={nkv} ps={ps} {dtype}"
                assert got.dtype == q.dtype and got.shape == q.shape, case
                assert torch.isfinite(got).all(), case
                assert (got.float() - want.float()).abs().max().item() <= TOL[dtype], case


def test_kernel_counts_launches_and_rejects_bad_input(dev):
    q, k, v, lens, tables = _case(dev, torch.float32, 2, 8, 2, 64, 8, 4, 9, [3, 32])
    before = paged_attention.launches
    paged_attention(q, k, v, lens, tables, 0.125)
    assert paged_attention.launches == before + 1
    with pytest.raises(TypeError):
        paged_attention(q.bfloat16(), k, v, lens, tables, 0.125)
    with pytest.raises(TypeError):
        paged_attention(q, k, v, lens.long(), tables, 0.125)
    with pytest.raises(NotImplementedError):
        paged_attention(q[:, :, :32].contiguous(), k[..., :32].contiguous(),
                        v[..., :32].contiguous(), lens, tables, 0.125)
    with pytest.raises(ValueError):
        paged_attention(q, k, v, lens, tables.t().contiguous().t(), 0.125)
    assert paged_attention.launches == before + 1


def test_engine_on_cuda_matches_cpu_and_runs_kernel(dev):
    config = ModelConfig.tiny(hidden_size=256, num_attention_heads=4, num_key_value_heads=2,
                              num_hidden_layers=3)
    params = init_params(torch.Generator().manual_seed(0), config, device="cpu")
    rng = np.random.default_rng(0)
    prompts = [rng.integers(1, config.vocab_size, size=n) for n in (5, 17, 30)]

    def run(device):
        eng = ServingEngine(params_from_numpy(params_to_numpy(params), device), config,
                            device=device, num_pages=32, page_size=8, max_batch=2,
                            max_pages_per_seq=8)
        rids = [eng.submit(pr, 12) for pr in prompts]
        out = eng.run()
        return [out[r] for r in rids], eng

    want, _ = run("cpu")
    before = paged_attention.launches
    got, eng = run(dev)
    assert got == want
    assert paged_attention.launches - before == config.num_hidden_layers * eng.decode_steps


def _flash_case(dev, dtype, b, nh, nkv, s, hd, seed=0):
    gen = torch.Generator(device=dev).manual_seed(seed)
    return tuple(torch.randn(b, heads, s, hd, generator=gen, device=dev).to(dtype).requires_grad_()
                 for heads in (nh, nkv, nkv))


def _out_and_grads(fn, q, k, v, groups, scale):
    out = fn(q, k, v, groups, scale)
    return (out.detach(),) + torch.autograd.grad((out.float() ** 2).sum(), (q, k, v))


def test_flash_kernels_match_plain(dev):
    """Forward and the three gradients of sum(o ** 2): head dims 64, 96, 128 and
    256, group sizes 1 to 8, lengths 1, tile +- 1 and ragged, a batch of 3, scales
    other than hd ** -0.5, fp32 and bf16. Gradients are held to 2e-2 of the
    plain gradient's max (the JAX package's gate for its TPU kernels)."""
    for b, nh, nkv, s, hd, scale in ((1, 8, 2, 1, 64, 0.125), (3, 4, 4, 63, 64, 0.125),
                                     (1, 8, 1, 64, 64, 0.3), (2, 8, 2, 65, 128, 0.05),
                                     (1, 16, 4, 300, 64, 0.125), (1, 4, 2, 257, 128, 128 ** -0.5),
                                     (1, 4, 4, 130, 96, 96 ** -0.5), (2, 8, 2, 65, 96, 0.2),
                                     (1, 8, 1, 97, 256, 256 ** -0.5), (2, 4, 4, 33, 256, 0.2)):
        for dtype in (torch.float32, torch.bfloat16):
            q, k, v = _flash_case(dev, dtype, b, nh, nkv, s, hd)
            got = _out_and_grads(flash_attention, q, k, v, nh // nkv, scale)
            want = _out_and_grads(flash_attention_reference, q, k, v, nh // nkv, scale)
            torch.cuda.synchronize()
            case = f"B={b} nh={nh} nkv={nkv} S={s} hd={hd} {dtype}"
            assert got[0].dtype == dtype and got[0].shape == q.shape, case
            assert all(torch.isfinite(t).all() for t in got), case
            assert (got[0].float() - want[0].float()).abs().max().item() <= TOL[dtype], case
            floor = 1e-3 * max(w.float().abs().max().item() for w in want[1:])
            for g, w in zip(got[1:], want[1:]):
                assert g.dtype == dtype and g.shape == w.shape, case
                err = (g.float() - w.float()).abs().max().item()
                assert err <= 2e-2 * max(w.float().abs().max().item(), floor), case


def test_flash_counts_launches_is_reproducible_and_rejects_bad_input(dev):
    q, k, v = _flash_case(dev, torch.bfloat16, 2, 8, 2, 100, 64)
    before = dict(flash_attention.launches)
    first = _out_and_grads(flash_attention, q, k, v, 4, 0.125)
    assert flash_attention.launches == {n: c + 1 for n, c in before.items()}
    with torch.no_grad():
        flash_attention(q, k, v, 4, 0.125)
    assert flash_attention.launches == {"fwd": before["fwd"] + 2, "dkv": before["dkv"] + 1,
                                        "dq": before["dq"] + 1}
    again = _out_and_grads(flash_attention, q, k, v, 4, 0.125)
    for a, b in zip(first, again):
        assert torch.equal(a, b)  # no atomics: the same bits from run to run
    counted = dict(flash_attention.launches)
    with pytest.raises(NotImplementedError):
        flash_attention(q[..., :32].contiguous(), k[..., :32].contiguous(),
                        v[..., :32].contiguous(), 4, 0.125)
    with pytest.raises(TypeError):
        flash_attention(q.half(), k.half(), v.half(), 4, 0.125)
    with pytest.raises(ValueError):
        flash_attention(q, k, v, 2, 0.125)
    with pytest.raises(ValueError):
        flash_attention(q.transpose(1, 2).contiguous().transpose(1, 2), k, v, 4, 0.125)
    with pytest.raises(ValueError):
        flash_attention(q, k.cpu(), v, 4, 0.125)
    assert flash_attention.launches == counted


def test_model_forward_takes_the_flash_route_on_cuda(dev):
    import dataclasses

    config = ModelConfig.tiny(hidden_size=256, num_attention_heads=4, num_key_value_heads=2,
                              num_hidden_layers=3, query_pre_attn_scalar=100.0)
    params = init_params(torch.Generator(device=dev).manual_seed(0), config, device=dev)
    ids = torch.arange(70, device=dev)[None] % config.vocab_size
    with torch.no_grad():
        want = forward(params, ids, config=config)["logits"]
        before = flash_attention.launches["fwd"]
        got = forward(params, ids, config=dataclasses.replace(
            config, use_flash_attention=True))["logits"]
        assert flash_attention.launches["fwd"] == before + 3
        forward(params, ids, config=dataclasses.replace(config, use_flash_attention=True),
                attention_mask=torch.ones_like(ids))
        assert flash_attention.launches["fwd"] == before + 3  # a padding mask: plain path
    assert (got - want).abs().max().item() <= 1e-4


def test_compression_engine_on_cuda_chooses_the_cpu_engine_layers_and_ranks(dev):
    config = ModelConfig.tiny(hidden_size=256, num_attention_heads=4, num_key_value_heads=2,
                              num_hidden_layers=4, use_flash_attention=True)
    params = init_params(torch.Generator().manual_seed(1), config, device="cpu")
    rng = np.random.default_rng(7)
    rows = rng.integers(0, config.vocab_size, (3, 1, 41))
    batches = [{"input_ids": r[:, :-1], "labels": r[:, 1:]} for r in rows]
    cfg = GraspConfig(num_prune_layers=2, compression_ratio=0.6)
    cpu = GraspEngine(params, config, device="cpu")
    want = cpu.run(batches, cfg)
    for name in flash_attention.launches:
        flash_attention.launches[name] = 0
    gpu = GraspEngine(params, config, device=dev)
    got = gpu.run(batches, cfg)
    assert got["redundant_layers"] == want["redundant_layers"]
    assert got["rank_dict"] == want["rank_dict"] and gpu.plan == cpu.plan
    np.testing.assert_allclose(got["layer_importances"], want["layer_importances"], rtol=1e-3)
    forwards = len(batches) * (1 + 2 * 2)
    above = sum((4 - 1 - li) + (4 - li) for li in got["redundant_layers"])
    assert flash_attention.launches == {"fwd": 4 * forwards, "dkv": len(batches) * above,
                                        "dq": len(batches) * above}
    for name in want["rank_dict"]:
        same = len(set(gpu.indices_log[name].tolist()) & set(cpu.indices_log[name].tolist()))
        assert same >= 0.9 * len(cpu.indices_log[name]), name


def test_hf_files_written_from_the_device_read_back_on_it(dev, tmp_path):
    """write_safetensors takes CUDA tensors of every dtype it knows and
    read_safetensors gives their bits back; an HF directory saved from bf16
    params on the card loads onto the card leaf for leaf torch.equal."""
    from grasp_tpu_torch.models.convert import flatten_params
    from grasp_tpu_torch.models.hf_io import (
        load_hf_checkpoint,
        read_safetensors,
        save_hf_checkpoint,
        write_safetensors,
    )

    gen = torch.Generator(device=dev).manual_seed(4)
    base = torch.randn(3, 5, generator=gen, device=dev)
    tensors = {f"t.{dt}": (base * 50).to(dt) for dt in (
        torch.float64, torch.float32, torch.float16, torch.bfloat16, torch.int64, torch.int32,
        torch.int16, torch.int8, torch.uint8, torch.bool)}
    write_safetensors(tensors, str(tmp_path / "all.safetensors"))
    back = read_safetensors(str(tmp_path / "all.safetensors"))
    assert back.keys() == tensors.keys()
    for name, t in tensors.items():
        assert torch.equal(back[name].to(dev), t), name

    config = ModelConfig.tiny(hidden_size=192, num_attention_heads=2, num_key_value_heads=2,
                              num_hidden_layers=2, dtype="bfloat16")
    params = init_params(torch.Generator(device=dev).manual_seed(5), config, device=dev)
    save_hf_checkpoint(params, config, str(tmp_path / "hf"), model_type="phi3",
                       dtype=torch.bfloat16)
    got_config, got = load_hf_checkpoint(str(tmp_path / "hf"), dtype=torch.bfloat16, device=dev)
    assert got_config.head_dim_ == 96
    want, have = flatten_params(params), flatten_params(got)
    assert want.keys() == have.keys()
    for name in want:
        assert have[name].device == want[name].device and torch.equal(have[name], want[name]), name
