"""grasp_tpu_torch's CUDA kernels against their plain versions, on the card.

Needs an NVIDIA GPU and no JAX; from the repository root:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py

Every test is marked ``cuda`` and skips where torch sees no CUDA device.
"""

import numpy as np
import pytest
import torch

from grasp_tpu.configs import ModelConfig
from grasp_tpu_torch.models.convert import params_from_numpy, params_to_numpy
from grasp_tpu_torch.models.llama import init_params
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
