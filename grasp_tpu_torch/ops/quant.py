"""Int8 / int4 weight quantization for serving (counterpart of grasp_tpu/ops/quant.py).

Projection kernels (dense and low-rank factors) are stored as int8 with one
fp32 scale per output channel, or as nibble-packed int4 with one fp32 scale
per (contraction group, output channel). Decoding is bound by the weight bytes
read per token, so fewer bits per weight is fewer bytes per token.
Activations stay bf16/fp32.

Quantized params keep the same tree keys with a ``_q`` / ``_q4`` / ``_scale``
suffix (``kernel`` -> ``kernel_q`` + ``kernel_scale``), so the projection plan
is unchanged. Quantization is symmetric absmax. The ints and scales are
bit-equal to the JAX package's for the same weights.

The int8 product and the dequantize-then-multiply branch of the int4 product
are plain matrix products, as they are plain XLA dots in the JAX package.
Decode-shaped int4 products (at most 64 rows, groups a multiple of 128) go to
the hand-written kernel of :mod:`grasp_tpu_torch.ops.int4_matmul` on CUDA
tensors. :func:`quantize_int8_stochastic` is the stochastic-rounding quantizer
(csrc/quantize_int8.cu on CUDA tensors, launched with :func:`quantize_plan`;
its plain version, bit-equal to it, on CPU tensors).
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Any, Dict, List, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

from grasp_tpu_torch.models.convert import flatten_params

_QUANTIZABLE = ("kernel", "in_kernel", "out_kernel")
INT4_KERNEL_MAX_ROWS = 64  # rows beyond which the weight read amortizes
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


def _round_up(x: int, m: int) -> int:
    return -(-x // m) * m


def _absmax_scale(absmax: torch.Tensor, qmax: float, reciprocal: bool) -> torch.Tensor:
    """absmax / qmax, 1 where absmax is 0. The JAX package computes this both
    ways: called directly its division is a true division; inside the jit
    that ``quantize_model_weights`` runs each kernel through, XLA turns the
    division by a constant into a product with the fp32 reciprocal, which can
    differ in the last bit. ``reciprocal`` picks the second."""
    # a tensor operand: torch on CUDA divides by a Python scalar through its
    # reciprocal, and the scales must not depend on the device
    if reciprocal:
        scaled = absmax * torch.tensor(1.0 / qmax, dtype=torch.float32, device=absmax.device)
    else:
        scaled = absmax / torch.tensor(qmax, dtype=torch.float32, device=absmax.device)
    return torch.where(absmax == 0, 1.0, scaled)


def quantize_int8(w: torch.Tensor, axis: int = 0,
                  reciprocal: bool = False) -> Tuple[torch.Tensor, torch.Tensor]:
    """Symmetric absmax int8 quantization along ``axis`` (the contraction
    dim). Returns (values int8, scale fp32) with w ~= values * scale, the
    scale shaped to broadcast over ``axis``. Rounds half to even.
    ``reciprocal``: see :func:`_absmax_scale`."""
    wf = w.float()
    absmax = wf.abs().amax(dim=axis, keepdim=True)
    scale = _absmax_scale(absmax, 127.0, reciprocal)
    q = torch.clamp(torch.round(wf / scale), -127, 127).to(torch.int8)
    return q, scale


def dequantize(q: torch.Tensor, scale: torch.Tensor,
               dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
    return (q.float() * scale).to(dtype)


def quant_matmul(x: torch.Tensor, q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """y = x @ (q * scale), int8 per output channel: q [in, out] int8, scale
    [1, out] fp32. The scale commutes out of the contraction: (x @ q) in
    fp32, times the scale, rounded once to x's dtype, as the JAX package's
    dot with an fp32 result. On CUDA a bf16 or fp16 x multiplies q in x's
    dtype into an fp32 result (cuBLAS's ``mm`` with ``out_dtype``); on the
    CPU, where PyTorch has no such ``mm``, the operands are fp32 (x and the
    int8 values are exact there)."""
    if x.device.type == "cuda" and x.dtype in (torch.bfloat16, torch.float16):
        y = torch.mm(x.reshape(-1, x.shape[-1]), q.to(x.dtype), out_dtype=torch.float32)
        y = y.reshape(*x.shape[:-1], q.shape[-1])
    else:
        y = torch.matmul(x.float(), q.float())
    return (y * scale.float()).to(x.dtype)


def quantize_int4(w: torch.Tensor, axis: int = 0, group_size: int = 128,
                  reciprocal: bool = False) -> Tuple[torch.Tensor, torch.Tensor]:
    """Symmetric absmax int4 quantization, group-wise along the contraction
    axis (axis 0): values in [-7, 7], one fp32 scale per (group, out channel).

    Storage is nibble-packed into int8, interleaved along the zero-padded
    contraction dim: byte i holds row 2i in its low nibble and row 2i+1 in
    its high nibble. ``gs`` is ``group_size`` for more than ``group_size``
    rows, else the rows rounded up to 2 (one group). Returns (packed int8
    [in_pad/2, out], scale fp32 [in_pad/gs, out]). ``reciprocal``: see
    :func:`_absmax_scale`."""
    if axis != 0:
        raise ValueError("group-wise quantization is along the contraction axis (0)")
    if group_size % 2:
        raise ValueError(f"group_size must be even, got {group_size}")
    in_f, out_f = w.shape
    gs = group_size if in_f > group_size else _round_up(in_f, 2)
    in_pad = _round_up(in_f, gs)
    g = in_pad // gs
    wf = F.pad(w.float(), (0, 0, 0, in_pad - in_f)).reshape(g, gs, out_f)
    absmax = wf.abs().amax(dim=1, keepdim=True)
    scale = _absmax_scale(absmax, 7.0, reciprocal)
    q = torch.clamp(torch.round(wf / scale), -7, 7).to(torch.int8).reshape(in_pad, out_f)
    lo, hi = q[0::2], q[1::2]
    packed = (hi << 4) | (lo & 0xF)
    return packed.contiguous(), scale.reshape(g, out_f)


def unpack_int4(packed: torch.Tensor) -> torch.Tensor:
    """Packed int8 [..., P, out] -> int4 values (as int8) [..., 2P, out]:
    out[2i] is the sign-extended low nibble of byte i, out[2i+1] its high
    nibble (arithmetic shifts)."""
    lo = (packed << 4) >> 4
    hi = packed >> 4
    shape = (*packed.shape[:-2], 2 * packed.shape[-2], packed.shape[-1])
    return torch.stack([lo, hi], dim=-2).reshape(shape)


def int4_group_size(in_f: int, packed_rows: int, groups: int) -> int:
    """The group size of a packed weight of ``packed_rows`` rows in
    ``groups`` groups, checked against an activation width ``in_f`` (the
    quantizer pads the contraction by less than one group)."""
    in_pad = 2 * packed_rows
    if groups == 0 or in_pad % groups or not in_pad - in_pad // groups < in_f <= in_pad:
        raise ValueError(f"activation width {in_f} does not fit {packed_rows} packed rows "
                         f"in {groups} groups")
    return in_pad // groups


def int4_geometry(in_f: int, packed: torch.Tensor, scale: torch.Tensor):
    """(groups, group size, padded contraction length) of a packed weight,
    checked against an activation width ``in_f``."""
    if packed.dim() != 2 or scale.dim() != 2 or packed.shape[1] != scale.shape[1]:
        raise ValueError(f"bad int4 weight: packed {tuple(packed.shape)}, "
                         f"scale {tuple(scale.shape)}")
    g = scale.shape[0]
    return g, int4_group_size(in_f, packed.shape[0], g), 2 * packed.shape[0]


def takes_int4_kernel(rows: int, gs: int) -> bool:
    """The dispatch rule of :func:`quant_matmul_int4` on CUDA tensors."""
    return gs % 128 == 0 and rows <= INT4_KERNEL_MAX_ROWS


def quant_matmul_int4(x: torch.Tensor, packed: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """y = x @ dequant(packed, scale) with group-wise scales.

    On CUDA tensors, decode-shaped calls (at most 64 rows, group size a
    multiple of 128) go to the fused kernel, which reads the packed weight
    once; everything else dequantizes once and runs one dense product (the
    weight read is amortized over the rows). CPU tensors always take the
    dequantize-dense branch, as the JAX package does off the TPU."""
    in_f = x.shape[-1]
    g, gs, in_pad = int4_geometry(in_f, packed, scale)
    rows = x.numel() // max(in_f, 1)
    if x.device.type == "cuda" and takes_int4_kernel(rows, gs):
        from grasp_tpu_torch.ops.int4_matmul import int4_matmul

        return int4_matmul(x.contiguous(), packed, scale)
    xp = F.pad(x, (0, in_pad - in_f)) if in_pad != in_f else x
    w = unpack_int4(packed).float().reshape(g, gs, -1)
    w = (w * scale[:, None, :].float()).reshape(in_pad, -1).to(x.dtype)
    return torch.matmul(xp, w)


def quantize_proj(proj: Dict[str, Any], bits: int = 8, group_size: int = 128) -> Dict[str, Any]:
    """Quantize one projection's kernels (returns a new dict), with the
    scales the JAX package's jitted quantizer gives."""
    if bits not in (4, 8):
        raise ValueError(f"bits must be 4 or 8, got {bits}")
    out: Dict[str, Any] = {}
    for key, val in proj.items():
        if key not in _QUANTIZABLE:
            out[key] = val
        elif bits == 8:
            out[key + "_q"], out[key + "_scale"] = quantize_int8(val, 0, reciprocal=True)
        else:
            out[key + "_q4"], out[key + "_scale"] = quantize_int4(val, 0, group_size,
                                                                  reciprocal=True)
    return out


def quantize_experts(ex: Dict[str, torch.Tensor], bits: int = 8,
                     group_size: int = 128) -> Dict[str, torch.Tensor]:
    """Quantize an MoE block's stacked dense experts ([E, in, out] each)
    expert by expert: ``w*_q`` (bits 8) or ``w*_q4`` (bits 4) beside
    ``w*_scale`` ([E, 1, out] or [E, G, out]). The JAX package quantizes the
    experts outside its jitted quantizer, so the scales here are true
    divisions (``reciprocal=False``), not those of :func:`quantize_proj`.
    GRASP low-rank experts (``w*_a`` / ``w*_b``) raise: the MoE block has no
    quantized low-rank form, in either package."""
    if bits not in (4, 8):
        raise ValueError(f"bits must be 4 or 8, got {bits}")
    low = sorted(k for k in ex if k.endswith(("_a", "_b")))
    if low:
        raise NotImplementedError(f"GRASP low-rank experts {low} do not quantize; merge them "
                                  "into dense experts first")
    out: Dict[str, torch.Tensor] = {}
    for w, stacked in ex.items():
        if bits == 8:  # per expert and output channel: the absmax over axis 1
            out[w + "_q"], out[w + "_scale"] = quantize_int8(stacked, 1)
        else:
            qs = [quantize_int4(m, 0, group_size) for m in stacked]
            out[w + "_q4"] = torch.stack([q for q, _ in qs])
            out[w + "_scale"] = torch.stack([sc for _, sc in qs])
    return out


def quantize_model_weights(params: Dict[str, Any], quantize_lm_head: bool = True, bits: int = 8,
                           group_size: int = 128, consume: bool = False) -> Dict[str, Any]:
    """Quantize every projection kernel (dense and low-rank) to int8 or int4.

    bits=8: per-output-channel absmax. bits=4: group-wise absmax along the
    contraction dim. The lm_head (the largest weight read per decoded token)
    is quantized by default; embeddings and norms keep their dtype. MoE
    layers quantize their stacked experts expert by expert
    (:func:`quantize_experts`) and keep the router gate.

    consume=True releases each source layer as soon as its quantized copy is
    built (the input tree is emptied in place), so that the peak holds the
    quantized tree plus one source layer rather than both trees."""
    from grasp_tpu_torch.models.llama import ATTN_PROJS, MLP_PROJS  # llama imports this module

    if consume and not isinstance(params.get("layers"), list):
        raise ValueError("consume=True requires a mutable params dict with a list of layers")
    layers = []
    src_layers = params["layers"]
    for li, layer in enumerate(src_layers):
        new_layer = dict(layer)
        groups = [("self_attn", ATTN_PROJS)] + ([("mlp", MLP_PROJS)] if "mlp" in layer else [])
        for group, names in groups:
            new_group = dict(layer[group])
            for name in names:
                new_group[name] = quantize_proj(layer[group][name], bits, group_size)
            new_layer[group] = new_group
        if "moe" in layer:
            new_layer["moe"] = {"gate": layer["moe"]["gate"],
                                "experts": quantize_experts(layer["moe"]["experts"], bits,
                                                            group_size)}
        layers.append(new_layer)
        if consume:
            src_layers[li] = None
    out = {**params, "layers": layers}
    if quantize_lm_head and "lm_head" in params:
        out["lm_head"] = quantize_proj(params["lm_head"], bits, group_size)
        if consume:
            params["lm_head"] = None
    if consume:
        params.clear()
    return out


def quantized_size_bytes(params: Dict[str, Any]) -> int:
    return sum(t.numel() * t.element_size() for t in flatten_params(params).values())


# ---------------------------------------------------------------------------
# Stochastic-rounding int8 quantizer
# ---------------------------------------------------------------------------

_MASK32 = 0xFFFFFFFF
_PHILOX_MUL = (0xD2511F53, 0xCD9E8D57)
_PHILOX_WEYL = (0x9E3779B9, 0xBB67AE85)


def _mulhilo32(a: int, b: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(high, low) 32-bit words of a * b for a 32-bit constant ``a`` and int64
    words ``b`` in [0, 2**32). b is split into 16-bit halves, so that no
    product leaves int64 (a * b itself may reach 2**64)."""
    b_hi, b_lo = b >> 16, b & 0xFFFF
    p_hi = a * b_hi                                  # < 2**48
    low = ((p_hi & 0xFFFF) << 16) + a * b_lo         # < 2**49
    return (p_hi >> 16) + (low >> 32), low & _MASK32


def philox4x32_10(counter: Sequence[torch.Tensor], key: Tuple[int, int]) -> List[torch.Tensor]:
    """Philox4x32-10 (Salmon et al., Random123) in torch int64 arithmetic:
    four 32-bit words from a 128-bit counter (four int64 tensors of words in
    [0, 2**32)) and a 64-bit key (two 32-bit ints), as csrc/quantize_int8.cu
    computes them."""
    c0, c1, c2, c3 = counter
    k0, k1 = key
    for _ in range(10):
        hi0, lo0 = _mulhilo32(_PHILOX_MUL[0], c0)
        hi1, lo1 = _mulhilo32(_PHILOX_MUL[1], c2)
        c0, c1, c2, c3 = hi1 ^ c1 ^ k0, lo1, hi0 ^ c3 ^ k1, lo0
        k0, k1 = (k0 + _PHILOX_WEYL[0]) & _MASK32, (k1 + _PHILOX_WEYL[1]) & _MASK32
    return [c0, c1, c2, c3]


def stochastic_bits(n: int, seed: int, device: Optional[torch.device] = None) -> torch.Tensor:
    """The kernel's random word of each of ``n`` elements (int64 in [0,
    2**32)): Philox4x32-10 keyed by the 64-bit seed at the counter (quad lo,
    quad hi, 0, 0), quad = element index // 4; element i takes word i % 4."""
    seed = int(seed) & 0xFFFFFFFFFFFFFFFF
    quad = torch.arange(-(-n // 4), dtype=torch.int64, device=device)
    zero = torch.zeros_like(quad)
    words = philox4x32_10((quad & _MASK32, quad >> 32, zero, zero), (seed & _MASK32, seed >> 32))
    return torch.stack(words, dim=1).reshape(-1)[:n]


def quantize_int8_stochastic_plain(w: torch.Tensor, seed: int = 0
                                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of :func:`quantize_int8_stochastic`, bit for bit:
    the scales of :func:`quantize_int8`, q = clip(floor(w / scale + u), -127,
    127) with u = (bits >> 8) * 2**-24 from :func:`stochastic_bits`."""
    wf = w.float()
    scale = _absmax_scale(wf.abs().amax(dim=0, keepdim=True), 127.0, reciprocal=False)
    bits = stochastic_bits(wf.numel(), seed, w.device)
    u = (bits >> 8).float().reshape(wf.shape) * (1.0 / (1 << 24))
    q = torch.clamp(torch.floor(wf / scale + u), -127, 127).to(torch.int8)
    return q, scale


QUANT_STRIP_BYTES = 128   # a strip: 128 bytes of each row (64 bf16 or 32 fp32 columns)
QUANT_ROW_STEP = 32       # rows 256 threads cover in one pass (8 chunks of 16 bytes a row)
QUANT_MAX_CLUSTER = 8     # blocks of a strip: one portable cluster
QUANT_FIXED_SMEM = (8 + 2) * 64 * 4 + 16  # maxima: the block's, those received; scales; mbarrier
MAX_SHARED_BYTES = 232448


@dataclasses.dataclass(frozen=True)
class QuantizePlan:
    """How one call of the quantizer kernel is launched: ``grid`` = (strips
    of ``cols`` columns, ``cluster``); block j of a strip's cluster owns rows
    [j rows_per_block, (j + 1) rows_per_block), with ``threads`` threads.
    ``keep``: those rows stay in shared memory, so w is read from device
    memory once; else the kernel reads it twice. ``smem_bytes``: dynamic
    shared memory a block."""
    cols: int
    cluster: int
    rows_per_block: int
    threads: int
    keep: bool
    smem_bytes: int
    grid: Tuple[int, int]


@functools.lru_cache(maxsize=None)
def quantize_plan(in_f: int, out_f: int, dtype: torch.dtype = torch.bfloat16) -> QuantizePlan:
    """The launch plan of csrc/quantize_int8.cu for w [in_f, out_f], a pure
    function of the shape and dtype; the kernel refuses any other. A strip's
    rows go to as many blocks as a cluster holds, at least 32 rows each, and
    a block has as many threads (256, 512, 1024) as keep a thread at 16 rows
    or fewer: on an H100, 512 threads were faster than 256 at 704 rows a
    block (in 5632) and slower at 256 rows (PERF.md, Findings;
    scripts/quantizer_breakdown_torch.py)."""
    if dtype not in _DTYPE_CODES:
        raise TypeError(f"the quantizer kernel takes float32 or bfloat16, got {dtype}")
    if in_f < 1 or out_f < 1 or in_f * out_f >= 2 ** 31:
        raise ValueError(f"the quantizer kernel takes 1 to 2**31 - 1 elements, got {in_f}x{out_f}")
    cols = QUANT_STRIP_BYTES // (torch.finfo(dtype).bits // 8)
    cluster = min(QUANT_MAX_CLUSTER, -(-in_f // QUANT_ROW_STEP))
    rows = -(-in_f // cluster)
    cluster = -(-in_f // rows)  # no block without rows
    tile = rows * QUANT_STRIP_BYTES
    keep = QUANT_FIXED_SMEM + tile <= MAX_SHARED_BYTES
    threads = next((t for t in (256, 512) if rows <= 2 * t), 1024)
    return QuantizePlan(cols, cluster, rows, threads, keep,
                        QUANT_FIXED_SMEM + (tile if keep else 0), (-(-out_f // cols), cluster))


def quantize_int8_stochastic(w: torch.Tensor, seed: int = 0) -> Tuple[torch.Tensor, torch.Tensor]:
    """Int8 quantization of w [in, out] with unbiased (stochastic) rounding:
    per-output-channel absmax scales like :func:`quantize_int8`, values
    rounded down or up with probability equal to the fractional part.
    Returns (int8 [in, out], fp32 [1, out]).

    The random bits are Philox4x32-10 keyed by ``seed`` at a counter of the
    element index (:func:`stochastic_bits`): the same seed gives the same q.
    CUDA tensors launch the kernel with :func:`quantize_plan`'s plan or raise;
    CPU tensors take :func:`quantize_int8_stochastic_plain`, which gives the
    kernel's bits. ``quantize_int8_stochastic.launches`` counts kernel
    launches."""
    if w.dim() != 2:
        raise ValueError(f"w must be [in, out], got {tuple(w.shape)}")
    if w.device.type == "cpu":
        return quantize_int8_stochastic_plain(w, seed)
    if w.device.type != "cuda":
        raise ValueError(f"the quantizer runs on cpu or cuda, not {w.device}")
    if w.dtype not in _DTYPE_CODES:
        raise TypeError(f"the quantizer kernel takes float32 or bfloat16, got {w.dtype}")
    if not w.is_contiguous():
        raise ValueError("w must be contiguous")
    in_f, out_f = w.shape
    if in_f == 0 or out_f == 0 or w.numel() >= 2 ** 31:
        raise ValueError(f"the quantizer kernel takes 1 to 2**31 - 1 elements, got {in_f}x{out_f}")
    from grasp_tpu_torch.ops._build import load_library

    plan = quantize_plan(in_f, out_f, w.dtype)
    lib = load_library()
    q = torch.empty((in_f, out_f), dtype=torch.int8, device=w.device)
    scale = torch.empty((1, out_f), dtype=torch.float32, device=w.device)
    with torch.cuda.device(w.device):
        stream = torch.cuda.current_stream(w.device).cuda_stream
        rc = lib.grasp_quantize_int8_stochastic(
            w.data_ptr(), q.data_ptr(), scale.data_ptr(), in_f, out_f, _DTYPE_CODES[w.dtype],
            plan.cluster, plan.rows_per_block, plan.threads, int(plan.keep), plan.smem_bytes,
            int(seed) & 0xFFFFFFFFFFFFFFFF, stream)
    if rc != 0:
        raise RuntimeError(f"int8 quantizer kernel launch failed: cudaError {rc}")
    quantize_int8_stochastic.launches += 1
    return q, scale


quantize_int8_stochastic.launches = 0
