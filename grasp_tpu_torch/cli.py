"""Command-line entry points of the port (counterpart of grasp_tpu/cli.py).

``grasp-compress-torch``: the GRASP compression pipeline (block influence,
SVD, calibration gradient sweeps, rank selection, low-rank compilation) on a
port checkpoint or a named preset, saved as a port checkpoint; sequential
rounds or one parallel sweep (``--sweep``), resumable after a crash
(``--compress_resume_dir``), ``--remat`` for the sweeps' memory and the gram
SVD (``--svd_method gram``). Recovery training, evaluation, HF export and
meshes are not ported yet and raise NotImplementedError.

``grasp-serve-torch``: OpenAI-style HTTP completions over the paged engine,
from a grasp_tpu_torch checkpoint directory (``grasp_meta.json`` +
``params.pt``; grasp_tpu checkpoints convert with
``scripts/convert_grasp_tpu_checkpoint.py``) or a named architecture preset
with random weights made from ``--seed``; ``--quantize int8|int4`` serves a
quantized copy of the weights, ``--quantized_kv`` keeps the KV pages in int8,
and ``--speculative int8 --gamma N`` drafts N tokens a step with an int8 copy
of the weights and verifies them with the served weights in one forward
(greedy outputs are the plain engine's). A checkpoint whose model config has
``use_pallas_lowrank`` runs its low-rank projections through the fused kernel
at 256 rows or more (prefill). HF checkpoint import, the prefix cache and
chunked prefill are not ported yet.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import logging
import os
import sys
from typing import Optional

import torch

logger = logging.getLogger("grasp_tpu_torch")

_PRESETS = {
    "tiny": "tiny",
    "tinyllama-1.1b": "tinyllama_1_1b",
    "llama2-7b": "llama2_7b",
    "llama3-8b": "llama3_8b",
    "llama3.1-8b": "llama3_1_8b",
    "mistral-7b": "mistral_7b",
    "qwen2-7b": "qwen2_7b",
    "phi3-mini-4k": "phi3_mini_4k",
    "mixtral-8x7b": "mixtral_8x7b",
    "gemma-2b": "gemma_2b",
    "gemma-7b": "gemma_7b",
    "gemma2-9b": "gemma2_9b",
}


def setup_logger(log_file: Optional[str] = None) -> None:
    logger.setLevel(logging.INFO)
    logger.handlers.clear()
    handler = logging.FileHandler(log_file) if log_file else logging.StreamHandler()
    handler.setFormatter(logging.Formatter("%(asctime)s - %(name)s - %(levelname)s - %(message)s"))
    logger.addHandler(handler)


def load_model(name_or_path: str, *, device, dtype: str = "float32", seed: int = 0):
    """(config, params, plan, tokenizer) from a port checkpoint directory or
    a named preset (random init from ``seed``; the checkpoint keeps its own
    dtype, a preset takes ``dtype``)."""
    from grasp_tpu_torch.configs import ModelConfig
    from grasp_tpu_torch.data.tokenizer import load_tokenizer
    from grasp_tpu_torch.models.llama import default_plan, init_params

    if os.path.isdir(name_or_path):
        if not os.path.exists(os.path.join(name_or_path, "grasp_meta.json")):
            raise NotImplementedError(
                f"{name_or_path} has no grasp_meta.json: HF checkpoint import is not "
                "ported yet")
        from grasp_tpu_torch.checkpoints import load_checkpoint

        params, config, plan, _meta = load_checkpoint(name_or_path, device)
        return config, params, plan, load_tokenizer(None)
    key = name_or_path.lower()
    if key not in _PRESETS:
        raise FileNotFoundError(f"{name_or_path!r} is neither a checkpoint directory nor a "
                                f"preset ({sorted(_PRESETS)})")
    # the tiny preset pairs with the ByteTokenizer fallback (259 ids)
    config = (ModelConfig.tiny(vocab_size=260) if key == "tiny"
              else getattr(ModelConfig, _PRESETS[key])())
    config = dataclasses.replace(config, dtype=dtype)
    gen = torch.Generator(device=device).manual_seed(seed)
    params = init_params(gen, config, device=device)
    logger.info("preset %s: RANDOM-INIT weights (seed %d)", key, seed)
    return config, params, default_plan(config), load_tokenizer(None)


def _compress_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="GRASP model compression (PyTorch/CUDA)")
    p.add_argument("--model_name_or_path", type=str, required=True,
                   help="grasp_tpu_torch checkpoint dir or preset name")
    p.add_argument("--dataset_name", type=str, default="wikitext2",
                   help="wikitext2 | c4 | synthetic")
    p.add_argument("--layers_id", type=int, nargs="+", default=None)
    p.add_argument("--num_prune_layers", type=int, default=None)
    p.add_argument("--mlp_target_layer_types", type=str, nargs="+",
                   default=["down_proj", "up_proj", "gate_proj"])
    p.add_argument("--attn_target_layer_types", type=str, nargs="+",
                   default=["q_proj", "k_proj", "v_proj", "o_proj"])
    p.add_argument("--metric", type=str, choices=["gradient", "taylor"], default="taylor")
    p.add_argument("--compression_ratio", type=float, default=None)
    p.add_argument("--threshold_ratio", type=float, default=None)
    p.add_argument("--save_path", type=str, default=None)
    p.add_argument("--angular", action="store_true")
    p.add_argument("--merge", action="store_true")
    p.add_argument("--verbose", action="store_true")
    p.add_argument("--num_samples", type=int, default=1024)
    p.add_argument("--batch_size", type=int, default=1)
    p.add_argument("--seq_len", type=int, default=512)
    p.add_argument("--seed", type=int, default=42)
    p.add_argument("--log_file", type=str, default=None)
    p.add_argument("--dtype", type=str, default="float32", choices=["float32", "bfloat16"])
    p.add_argument("--data_root", type=str, default=".")
    p.add_argument("--device", type=str, default="cuda")
    p.add_argument("--sweep", type=str, choices=["sequential", "parallel"], default="sequential")
    p.add_argument("--grad_mode", type=str, choices=["dense", "svd"], default="dense")
    p.add_argument("--remat", action="store_true",
                   help="recompute each layer's activations in the sweeps' backward")
    p.add_argument("--svd_method", type=str, choices=["auto", "host", "device", "gram"],
                   default="auto", help="SVD backend: torch.linalg.svd on the device (auto, "
                                        "device), host LAPACK, or gram (the Gram matrix on "
                                        "the device, its eigendecomposition on the host)")
    p.add_argument("--compress_resume_dir", type=str, default=None,
                   help="crash-resume directory: the engine snapshots its state there after "
                        "block influence and every round; a rerun with the same directory "
                        "goes on at the first round not done")
    # parsed so that a grasp-compress command line carries over; each raises
    p.add_argument("--dp", type=int, default=1)
    p.add_argument("--tp", type=int, default=1)
    p.add_argument("--export_hf_dir", type=str, default=None)
    p.add_argument("--recovery", action="store_true")
    p.add_argument("--evaluate", action="store_true")
    return p


def compress_main(argv=None) -> int:
    """``grasp-compress-torch``: compress a model and save the checkpoint."""
    args = _compress_parser().parse_args(argv)
    setup_logger(args.log_file)
    unported = {"--recovery": args.recovery, "--evaluate": args.evaluate,
                "--export_hf_dir": args.export_hf_dir, "--dp/--tp": args.dp * args.tp > 1}
    for flag, asked in unported.items():
        if asked:
            raise NotImplementedError(f"grasp-compress-torch does not support {flag} yet")
    from grasp_tpu_torch.checkpoints import save_checkpoint
    from grasp_tpu_torch.configs import GraspConfig
    from grasp_tpu_torch.core.engine import GraspEngine
    from grasp_tpu_torch.data.loader import get_calibration_batches

    device = torch.device(args.device)
    config, params, plan, tokenizer = load_model(args.model_name_or_path, device=device,
                                                 dtype=args.dtype, seed=args.seed)
    batches = get_calibration_batches(
        args.dataset_name, tokenizer, num_samples=args.num_samples, seq_len=args.seq_len,
        batch_size=args.batch_size, seed=args.seed, data_root=args.data_root)
    logger.info("=======> Done Loading Data! (%d batches)", len(batches))

    cfg = GraspConfig(
        model_name_or_path=args.model_name_or_path,
        layers_id=args.layers_id,
        num_prune_layers=args.num_prune_layers,
        mlp_target_layer_types=tuple(args.mlp_target_layer_types),
        attn_target_layer_types=tuple(args.attn_target_layer_types),
        metric=args.metric,
        compression_ratio=args.compression_ratio,
        threshold_ratio=args.threshold_ratio,
        angular=args.angular,
        merge=args.merge,
        verbose=args.verbose,
        sweep=args.sweep,
        grad_mode=args.grad_mode,
        remat=args.remat,
    )
    engine = GraspEngine(params, config, plan, svd_method=args.svd_method, device=device,
                         remat=args.remat)
    summary = engine.run(batches, cfg, resume_dir=args.compress_resume_dir)
    logger.info("summary: %s", json.dumps(summary))

    save_path = args.save_path
    if not save_path:
        os.makedirs("./checkpoint", exist_ok=True)
        save_path = os.path.join("./checkpoint", args.model_name_or_path.replace("/", "-"))
    # the model's own config: a flash-attention switch made for the sweeps is
    # the engine's, not the checkpoint's
    save_checkpoint(save_path, engine.params, config, engine.plan,
                    rank_dict=engine.rank_dict, redundant_layers=engine.redundant_layers,
                    layer_importances=engine.layer_importances,
                    extra={"grasp_config": vars(args), "summary": summary})
    logger.info("checkpoint saved to %s", save_path)
    return 0


def _serve_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="GRASP serving (PyTorch/CUDA)")
    p.add_argument("--model_path", type=str, required=True,
                   help="grasp_tpu_torch checkpoint dir or preset name")
    p.add_argument("--tokenizer_path", type=str, default=None)
    p.add_argument("--model_name", type=str, default=None,
                   help="model id reported by /v1/models (default: model_path)")
    p.add_argument("--host", type=str, default="127.0.0.1")
    p.add_argument("--port", type=int, default=8000)
    p.add_argument("--device", type=str, default="cuda")
    p.add_argument("--dtype", type=str, default="bfloat16", choices=["float32", "bfloat16"],
                   help="parameter dtype of a preset (a checkpoint keeps its own)")
    p.add_argument("--seed", type=int, default=0, help="random-init seed of a preset")
    p.add_argument("--quantize", type=str, default="none", choices=["none", "int8", "int4"],
                   help="weight quantization for the serving copy")
    p.add_argument("--quantized_kv", action="store_true",
                   help="int8 KV pages (half the decode KV traffic)")
    p.add_argument("--speculative", type=str, default="none", choices=["none", "int8"],
                   help="int8: self-draft speculation (an int8-quantized copy drafts, the "
                        "served weights verify; greedy outputs identical)")
    p.add_argument("--gamma", type=int, default=4, help="speculation draft length")
    p.add_argument("--stop_token_ids", type=str, default=None,
                   help="comma-separated extra stop token ids beyond the tokenizer's eos")
    p.add_argument("--max_batch", type=int, default=8)
    p.add_argument("--num_pages", type=int, default=256)
    p.add_argument("--page_size", type=int, default=128)
    p.add_argument("--max_pages_per_seq", type=int, default=16)
    p.add_argument("--log_file", type=str, default=None)
    return p


def serve_main(argv=None, block: bool = True):
    """``grasp-serve-torch``. With ``block=False`` returns
    ``(GraspServer, ThreadingHTTPServer, thread)`` instead of serving
    forever (``--port 0`` picks a free port: ``httpd.server_address[1]``)."""
    args = _serve_parser().parse_args(argv)
    setup_logger(args.log_file)
    from grasp_tpu_torch.data.tokenizer import load_tokenizer
    from grasp_tpu_torch.ops.quant import quantize_model_weights
    from grasp_tpu_torch.serving.server import serve

    device = torch.device(args.device)
    config, params, plan, tokenizer = load_model(args.model_path, device=device,
                                                 dtype=args.dtype, seed=args.seed)
    if args.tokenizer_path:
        tokenizer = load_tokenizer(args.tokenizer_path)
    # the draft is quantized from the weights as loaded, before --quantize
    # consumes them
    draft = quantize_model_weights(params, bits=8) if args.speculative == "int8" else None
    if args.quantize != "none":
        # consume: the source tree is dropped layer by layer, so the peak
        # holds one tree and one layer, not both trees
        params = quantize_model_weights(params, bits=8 if args.quantize == "int8" else 4,
                                        consume=True)
    eos = getattr(tokenizer, "eos_token_id", None)
    if args.stop_token_ids:
        extra = [int(t) for t in args.stop_token_ids.split(",") if t.strip()]
        eos = ([int(eos)] if eos is not None else []) + extra
    kw = dict(device=device, num_pages=args.num_pages, page_size=args.page_size,
              max_batch=args.max_batch, max_pages_per_seq=args.max_pages_per_seq,
              eos_token_id=eos, quantized_kv=args.quantized_kv)
    if draft is not None:
        from grasp_tpu_torch.serving.spec_paged import SpeculativeServingEngine

        engine = SpeculativeServingEngine(params, config, draft, config, plan=plan,
                                          draft_plan=plan, gamma=args.gamma, **kw)
    else:
        from grasp_tpu_torch.serving.paged import ServingEngine

        engine = ServingEngine(params, config, plan, **kw)
    handles = serve(engine, host=args.host, port=args.port, tokenizer=tokenizer,
                    model_id=args.model_name or args.model_path, block=block)
    return 0 if block else handles


if __name__ == "__main__":
    sys.exit(serve_main())
