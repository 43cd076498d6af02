"""Command-line entry points of the port (counterpart of grasp_tpu/cli.py).

``grasp-compress-torch``: the GRASP compression pipeline (block influence,
SVD, calibration gradient sweeps, rank selection, low-rank compilation) on a
port checkpoint, a local HF checkpoint directory or a named preset, saved as
a port checkpoint and, with ``--export_hf_dir``, as a merged HF checkpoint
(models/hf_io.py: dense weights that transformers loads); sequential
rounds or one parallel sweep (``--sweep``), resumable after a crash
(``--compress_resume_dir``), ``--remat`` for the sweeps' memory and the gram
SVD (``--svd_method gram``); ``--recovery`` then fine-tunes the redundant
layers on a local Alpaca-format ``--data_path`` (GRASP*, train/recover.py:
trainer state under ``<save_path>_trainer``, the result saved as
``<save_path>_recovered``); ``--evaluate`` evaluates the compressed (or
recovered) model after the save (``--eval_ppl``, ``--eval_tasks``). Meshes
are not ported yet and raise NotImplementedError.

``grasp-evaluate-torch``: perplexity (``--eval_ppl``), zero/few-shot tasks or
LongBench (``--eval_tasks``) of a model, written to ``--results_json``.

``grasp-serve-torch``: OpenAI-style HTTP completions over the paged engine;
``--quantize int8|int4`` serves a quantized copy of the weights,
``--quantized_kv`` keeps the KV pages in int8, and ``--speculative int8
--gamma N`` drafts N tokens a step with an int8 copy of the weights and
verifies them with the served weights in one forward (greedy outputs are the
plain engine's). A checkpoint whose model config has
``use_pallas_lowrank`` runs its low-rank projections through the fused kernel
at 256 rows or more (prefill). ``--prefix_cache`` shares the K/V pages of
prompts that open alike between requests (only the suffix runs the prefill),
and ``--prefill_chunk N`` admits a prompt N tokens a step while the live rows
go on decoding (not with ``--speculative``). Requests take penalties, logit
bias, min_p and guided decoding (``guided_regex``, ``response_format``); the
speculative engine is built without the tokenizer, as in the JAX package, so
over HTTP it refuses ``guided_regex``.

Every entry point takes a model from a grasp_tpu_torch checkpoint directory
(``grasp_meta.json`` + ``params.pt``; grasp_tpu checkpoints convert with
``scripts/convert_grasp_tpu_checkpoint.py``), a local HF checkpoint directory
(``config.json`` + ``*.safetensors`` or ``pytorch_model*.bin``; its tokenizer
where it holds one, else the byte-level tokenizer) or a named architecture
preset with random weights made from ``--seed``.
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
    """(config, params, plan, tokenizer) from a port checkpoint directory, a
    local HF checkpoint directory (``config.json``, no ``grasp_meta.json``)
    or a named preset (random init from ``seed``). A port checkpoint keeps its
    own dtype; an HF directory and a preset take ``dtype``."""
    from grasp_tpu_torch.configs import ModelConfig
    from grasp_tpu_torch.data.tokenizer import load_tokenizer
    from grasp_tpu_torch.models.llama import (
        default_plan,
        init_params,
        plan_from_params,
        torch_dtype,
    )

    if os.path.isdir(name_or_path):
        if os.path.exists(os.path.join(name_or_path, "grasp_meta.json")):
            from grasp_tpu_torch.checkpoints import load_checkpoint

            params, config, plan, _meta = load_checkpoint(name_or_path, device)
            return config, params, plan, load_tokenizer(None)
        if not os.path.exists(os.path.join(name_or_path, "config.json")):
            raise FileNotFoundError(f"{name_or_path} holds neither grasp_meta.json (a port "
                                    "checkpoint) nor config.json (an HF checkpoint)")
        from grasp_tpu_torch.models.hf_io import load_hf_checkpoint

        config, params = load_hf_checkpoint(name_or_path, dtype=torch_dtype(dtype),
                                            device=device)
        config = dataclasses.replace(config, dtype=dtype)
        return config, params, plan_from_params(params, config), load_tokenizer(name_or_path)
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
                   help="grasp_tpu_torch checkpoint dir, HF checkpoint dir or preset name")
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
    # meshes: parsed so that a grasp-compress command line carries over; they raise
    p.add_argument("--dp", type=int, default=1)
    p.add_argument("--tp", type=int, default=1)
    p.add_argument("--export_hf_dir", type=str, default=None,
                   help="also write the compressed model as an HF checkpoint directory "
                        "(config.json + model.safetensors, low-rank projections merged "
                        "dense in float32) that transformers loads")
    # recovery (GRASP*): the redundant layers fine-tuned after compression
    p.add_argument("--recovery", action="store_true")
    p.add_argument("--data_path", type=str, default="yahma/alpaca-cleaned",
                   help="Alpaca-format rows: a local .json/.jsonl file or a datasets "
                        "save_to_disk directory (never downloaded)")
    p.add_argument("--train_batch_size", type=int, default=32)
    p.add_argument("--micro_batch_size", type=int, default=4)
    p.add_argument("--num_epochs", type=int, default=1)
    p.add_argument("--learning_rate", type=float, default=3e-4)
    p.add_argument("--max_length", type=int, default=256)
    p.add_argument("--val_set_size", type=int, default=2000)
    p.add_argument("--train_on_inputs", action="store_true")
    p.add_argument("--add_eos_token", action="store_true")
    p.add_argument("--prompt_template_name", type=str, default="alpaca")
    p.add_argument("--resume_from_checkpoint", type=str, default=None,
                   help="trainer output dir (or a step_N dir inside one) to resume from")
    p.add_argument("--eval_every", type=int, default=200,
                   help="eval + save cadence in optimizer steps (reference "
                        "alpaca_grasp.py:184-186)")
    p.add_argument("--save_total_limit", type=int, default=3)
    # evaluation of the compressed model
    p.add_argument("--evaluate", action="store_true")
    p.add_argument("--eval_ppl", type=str, default="")
    p.add_argument("--eval_tasks", type=str, default="")
    p.add_argument("--task_specs", type=str, default=None,
                   help="JSON file of declarative task specs (eval/task_spec.py) registered "
                        "before evaluation")
    p.add_argument("--num_fewshot", type=int, default=0)
    p.add_argument("--limit", type=int, default=-1)
    p.add_argument("--results_json", type=str, default=None,
                   help="write the evaluation results dict to this JSON file")
    return p


def compress_main(argv=None) -> int:
    """``grasp-compress-torch``: compress a model and save the checkpoint."""
    args = _compress_parser().parse_args(argv)
    setup_logger(args.log_file)
    if args.dp * args.tp > 1:
        raise NotImplementedError("grasp-compress-torch does not support --dp/--tp yet")
    # the recovery data is read before the compression, so that a missing file
    # fails at once rather than after the sweeps
    recovery_rows = _recovery_rows(args.data_path) if args.recovery else None
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
    if args.export_hf_dir:
        from grasp_tpu_torch.models.hf_io import save_hf_checkpoint

        save_hf_checkpoint(engine.params, config, args.export_hf_dir, merge=True)
        logger.info("HF export written to %s", args.export_hf_dir)
    if args.recovery:
        engine.params = _run_recovery(engine, config, tokenizer, args, save_path, recovery_rows)
    if args.evaluate:
        _run_evaluation(engine.params, config, engine.plan, tokenizer, args)
    return 0


def _recovery_rows(data_path: str) -> list:
    """Alpaca-format rows from a local .json/.jsonl file or a datasets
    directory; there is no download."""
    if data_path.endswith((".json", ".jsonl")):
        with open(data_path) as f:
            if data_path.endswith(".json"):
                return json.load(f)
            return [json.loads(line) for line in f]
    if os.path.isdir(data_path):
        from datasets import load_from_disk

        return list(load_from_disk(data_path))
    raise FileNotFoundError(f"recovery data {data_path!r} not found locally (no network)")


def recovery_batches(rows: list, tokenizer, args):
    """(train batches, validation batches or None) of ``--recovery``, as the
    JAX CLI makes them: ``rows`` tokenized with the prompt template, split by
    a fixed seed 42 (not ``--seed``) into validation (``min(val_set_size, n
    // 5)`` rows) and training, micro-batches of ``micro_batch_size`` rows
    right-padded to a multiple of 8 (an incomplete last one dropped)."""
    import numpy as np

    from grasp_tpu_torch.data.prompter import Prompter, collate_padded, tokenize_alpaca_example

    prompter = Prompter(args.prompt_template_name)
    examples = [tokenize_alpaca_example(r, tokenizer, prompter, max_length=args.max_length,
                                        train_on_inputs=args.train_on_inputs,
                                        add_eos_token=args.add_eos_token) for r in rows]
    order = np.random.default_rng(42).permutation(len(examples))
    val_n = min(args.val_set_size, len(examples) // 5)
    mb = args.micro_batch_size

    def batches(idx):
        return [collate_padded([examples[i] for i in idx[s:s + mb]], pad_token_id=0)
                for s in range(0, len(idx) - mb + 1, mb)]

    return batches(order[val_n:]), batches(order[:val_n]) or None


def _run_recovery(engine, config, tokenizer, args, save_path: str, rows: list):
    """GRASP* recovery of the compressed model on ``rows`` (grasp_tpu/cli.py's
    ``--recovery``): accumulation ``train_batch_size // micro_batch_size``,
    trainer state under ``<save_path>_trainer``; saves
    ``<save_path>_recovered`` with the history and returns its params."""
    from grasp_tpu_torch.checkpoints import save_checkpoint
    from grasp_tpu_torch.train.recover import recovery_train

    train_batches, val_batches = recovery_batches(rows, tokenizer, args)
    params, history = recovery_train(
        engine.params, config, engine.plan, engine.redundant_layers, train_batches, val_batches,
        num_epochs=args.num_epochs, learning_rate=args.learning_rate,
        accum_steps=max(args.train_batch_size // args.micro_batch_size, 1),
        remat=args.remat, eval_every=args.eval_every, output_dir=save_path + "_trainer",
        save_total_limit=args.save_total_limit,
        resume_from_checkpoint=args.resume_from_checkpoint)
    save_checkpoint(save_path + "_recovered", params, config, engine.plan,
                    rank_dict=engine.rank_dict, redundant_layers=engine.redundant_layers,
                    layer_importances=engine.layer_importances,
                    extra={"recovery_history": history})
    logger.info("recovered checkpoint saved to %s_recovered", save_path)
    return params


def _run_evaluation(params, config, plan, tokenizer, args) -> dict:
    """Perplexity of each corpus in ``args.eval_ppl``, then LongBench
    (``--eval_tasks longbench|small_longbench``) or the harness's tasks;
    the results dict, also written to ``args.results_json``."""
    results = {}
    data_root = args.data_root
    if args.eval_ppl:
        from grasp_tpu_torch.data.loader import get_evaluation_corpus
        from grasp_tpu_torch.eval.ppl import windowed_perplexity

        for ds in args.eval_ppl.split(","):
            corpus = get_evaluation_corpus(ds.strip(), tokenizer, data_root=data_root)
            results[ds] = windowed_perplexity(params, config, corpus, plan=plan, limit=args.limit)
            logger.info("%s ppl: %s", ds, results[ds])
    if args.task_specs:
        from grasp_tpu_torch.eval.task_spec import load_task_specs

        logger.info("registered task specs: %s", load_task_specs(args.task_specs))
    tasks = (args.eval_tasks or "").strip()
    if tasks in ("longbench", "small_longbench"):
        from grasp_tpu_torch.eval.longbench import (
            FULL_LONGBENCH_DATASETS,
            SMALL_LONGBENCH_DATASETS,
            eval_longbench,
        )

        ds = FULL_LONGBENCH_DATASETS if tasks == "longbench" else SMALL_LONGBENCH_DATASETS
        results.update(eval_longbench(params, config, tokenizer, args.model_name_or_path, ds,
                                      plan=plan, data_root=data_root))
    elif tasks:
        from grasp_tpu_torch.eval.harness import EvalLM, evaluate_tasks

        lm = EvalLM(params, config, tokenizer, plan=plan)
        results.update(evaluate_tasks(lm, [t.strip() for t in tasks.split(",")],
                                      num_fewshot=args.num_fewshot,
                                      limit=None if args.limit == -1 else args.limit,
                                      data_root=data_root))
    logger.info("results: %s", json.dumps(results))
    if args.results_json:
        os.makedirs(os.path.dirname(os.path.abspath(args.results_json)), exist_ok=True)
        with open(args.results_json, "w") as f:
            json.dump(results, f, indent=1)
    return results


def _evaluate_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="GRASP checkpoint evaluation (PyTorch/CUDA)")
    p.add_argument("--model_path", type=str, required=True,
                   help="grasp_tpu_torch checkpoint dir, HF checkpoint dir or preset name")
    p.add_argument("--tokenizer_path", type=str, default=None)
    p.add_argument("--model_name", type=str, default=None)
    p.add_argument("--eval_ppl", type=str, default="wikitext2,ptb,c4")
    p.add_argument("--eval_tasks", type=str, default="")
    p.add_argument("--task_specs", type=str, default=None,
                   help="JSON file of declarative task specs (eval/task_spec.py)")
    p.add_argument("--num_fewshot", type=int, default=0)
    p.add_argument("--limit", type=int, default=-1)
    p.add_argument("--data_root", type=str, default=".")
    p.add_argument("--log_file", type=str, default=None)
    p.add_argument("--results_json", type=str, default=None,
                   help="write the evaluation results dict to this JSON file")
    p.add_argument("--device", type=str, default="cuda")
    p.add_argument("--dtype", type=str, default="bfloat16", choices=["float32", "bfloat16"],
                   help="parameter dtype of a preset or an HF directory (a port checkpoint "
                        "keeps its own)")
    p.add_argument("--seed", type=int, default=0, help="random-init seed of a preset")
    return p


def evaluate_main(argv=None) -> int:
    """``grasp-evaluate-torch``: evaluate a checkpoint, an HF directory or a preset."""
    args = _evaluate_parser().parse_args(argv)
    setup_logger(args.log_file)
    from grasp_tpu_torch.data.tokenizer import load_tokenizer

    config, params, plan, tokenizer = load_model(args.model_path, device=torch.device(args.device),
                                                 dtype=args.dtype, seed=args.seed)
    if args.tokenizer_path:
        tokenizer = load_tokenizer(args.tokenizer_path)
    args.model_name_or_path = args.model_name or args.model_path
    _run_evaluation(params, config, plan, tokenizer, args)
    return 0


def _serve_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="GRASP serving (PyTorch/CUDA)")
    p.add_argument("--model_path", type=str, required=True,
                   help="grasp_tpu_torch checkpoint dir, HF checkpoint dir or preset name")
    p.add_argument("--tokenizer_path", type=str, default=None)
    p.add_argument("--model_name", type=str, default=None,
                   help="model id reported by /v1/models (default: model_path)")
    p.add_argument("--host", type=str, default="127.0.0.1")
    p.add_argument("--port", type=int, default=8000)
    p.add_argument("--device", type=str, default="cuda")
    p.add_argument("--dtype", type=str, default="bfloat16", choices=["float32", "bfloat16"],
                   help="parameter dtype of a preset or an HF directory (a port checkpoint "
                        "keeps its own)")
    p.add_argument("--seed", type=int, default=0, help="random-init seed of a preset")
    p.add_argument("--quantize", type=str, default="none", choices=["none", "int8", "int4"],
                   help="weight quantization for the serving copy")
    p.add_argument("--quantized_kv", action="store_true",
                   help="int8 KV pages (half the decode KV traffic)")
    p.add_argument("--prefix_cache", action="store_true",
                   help="share KV pages between requests whose prompts open with the same "
                        "pages (the shared prefix skips the prefill, in the target and in a "
                        "speculative draft)")
    p.add_argument("--prefill_chunk", type=int, default=None,
                   help="admit prompts this many tokens an engine step (a multiple of "
                        "--page_size) so that long prompts do not stall the running batch; "
                        "not with --speculative")
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
    p.add_argument("--chat_template", type=str, default=None,
                   choices=[None, "llama2", "chatml", "phi3", "gemma", "generic"],
                   help="chat rendering for /v1/chat/completions (default: the "
                        "tokenizer's own template, else generic)")
    p.add_argument("--log_file", type=str, default=None)
    return p


def serve_main(argv=None, block: bool = True):
    """``grasp-serve-torch``. With ``block=False`` returns
    ``(GraspServer, ThreadingHTTPServer, thread)`` instead of serving
    forever (``--port 0`` picks a free port: ``httpd.server_address[1]``)."""
    parser = _serve_parser()
    args = parser.parse_args(argv)
    if args.prefill_chunk and args.speculative != "none":
        parser.error("--prefill_chunk is not supported with --speculative")
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
              eos_token_id=eos, quantized_kv=args.quantized_kv, prefix_cache=args.prefix_cache)
    if draft is not None:
        from grasp_tpu_torch.serving.spec_paged import SpeculativeServingEngine

        engine = SpeculativeServingEngine(params, config, draft, config, plan=plan,
                                          draft_plan=plan, gamma=args.gamma, **kw)
    else:
        from grasp_tpu_torch.serving.paged import ServingEngine

        engine = ServingEngine(params, config, plan, prefill_chunk=args.prefill_chunk,
                               tokenizer=tokenizer, **kw)
    handles = serve(engine, host=args.host, port=args.port, tokenizer=tokenizer,
                    model_id=args.model_name or args.model_path,
                    chat_template=args.chat_template, block=block)
    return 0 if block else handles


if __name__ == "__main__":
    sys.exit(serve_main())
