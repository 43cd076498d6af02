"""The gram SVD paths of grasp_tpu_torch.ops.svd run their products in true
fp32 on the card, whatever the caller allows, as the JAX package's
``Precision.HIGHEST``; needs an NVIDIA GPU and no JAX:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda_gram.py

Marked ``cuda``; skips where torch sees no CUDA device.
"""

import pytest
import torch

from grasp_tpu_torch.ops import svd as tsvd

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


def _off_diagonal_error(g, want):
    """Largest error off the diagonal over the largest entry: there the fp32
    sums of random-signed terms are exact to ~1e-9, while TF32's rounding of
    each input to 10 bits leaves ~1e-5."""
    err = (g.double() - want).abs()
    err.fill_diagonal_(0)
    return (err.max() / want.abs().max()).item()


def test_gram_products_stay_fp32_when_the_caller_allows_tf32(dev):
    before = torch.get_float32_matmul_precision()
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        gen = torch.Generator(device=dev).manual_seed(0)
        w = torch.randn(2048, 5632, generator=gen, device=dev) * 0.02  # a gate/up kernel
        want = w.double() @ w.double().T
        tf32 = _off_diagonal_error(w @ w.T, want)
        with tsvd._fp32_products():
            fp32 = _off_diagonal_error(tsvd._gram(w), want)
        assert torch.backends.cuda.matmul.allow_tf32  # the caller's setting is back
        assert tf32 > 1e-6, f"TF32 did not show ({tf32:.2e}): the test cannot tell"
        assert fp32 < 1e-6, (fp32, tf32)
        # every gram path leaves the caller's setting as it found it and
        # reconstructs the kernel
        for method in ("gram", "gram_device"):
            u, s, vh = tsvd.svd(w, method=method)
            rec = (u.double() * s.double()) @ vh.double()
            assert ((rec - w.double()).abs().max() / w.abs().max()).item() < 1e-4, method
        s, basis, side = tsvd.gram_basis(w)
        assert side == "u" and torch.backends.cuda.matmul.allow_tf32
    finally:
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.set_float32_matmul_precision(before)
