"""Perplexity evaluation (counterpart of grasp_tpu/eval/ppl.py).

The reference's two procedures, with their quirks:

  - :func:`windowed_perplexity`: non-overlapping ``seqlen``-token windows over
    the whole corpus, the shift-by-1 mean cross entropy of each window,
    ppl = exp(sum(mean_ce * seqlen) / (n * seqlen)). Its ``limit`` stops
    AFTER window ``limit`` (limit + 1 windows).
  - :func:`evaluate_perplexity`: the rows of a pre-chunked [n, seq] id matrix
    with input = row[:-1], labels = row[1:]. Its ``limit`` stops BEFORE row
    ``limit`` (limit rows).

Windows run one at a time under ``torch.no_grad()``, so the peak holds one
window's logits and the fp32 log-softmax of the shifted ones (2047 x 32000 x
4 bytes, 262 MB, at TinyLlama's vocabulary). A forward without a cache or a padding
mask takes the flash-attention kernel when the config asks for it, and a
low-rank projection the fused kernel (models/llama.py).
"""

from __future__ import annotations

import logging
from typing import Optional

import numpy as np
import torch

from grasp_tpu_torch.configs import ModelConfig
from grasp_tpu_torch.models.llama import ModelPlan, Params, default_plan, forward

logger = logging.getLogger("grasp_tpu_torch")


def params_device(params: Params) -> torch.device:
    """The device the model's weights live on."""
    return params["embed_tokens"]["weight"].device


def _window_mean_ce(params: Params, window: torch.Tensor, config: ModelConfig,
                    plan: ModelPlan) -> float:
    """Shift-by-1 mean cross entropy of one window [s]: the fp32 log-softmax
    of the logits at 0..s-2 against the tokens at 1..s-1."""
    logits = forward(params, window[None], config=config, plan=plan)["logits"]
    logp = torch.log_softmax(logits[:, :-1].float(), dim=-1)
    return float(-logp.gather(-1, window[None, 1:, None]).mean())


def _row_mean_ce(params: Params, row: torch.Tensor, config: ModelConfig,
                 plan: ModelPlan) -> float:
    """Mean cross entropy of row[1:] under the logits of row[:-1]."""
    logits = forward(params, row[None, :-1], config=config, plan=plan)["logits"]
    logp = torch.log_softmax(logits.float(), dim=-1)
    return float(-logp.gather(-1, row[None, 1:, None]).mean())


def windowed_mean_ce(params: Params, config: ModelConfig, corpus_ids: np.ndarray,
                     plan: Optional[ModelPlan] = None, seqlen: int = 2048,
                     limit: int = -1) -> np.ndarray:
    """The mean cross entropy of each window that :func:`windowed_perplexity`
    averages, float64 [n]."""
    plan = plan or default_plan(config)
    nsamples = len(corpus_ids) // seqlen
    # the reference's loop breaks AFTER processing window i == limit
    n_eff = nsamples if limit < 0 else min(limit + 1, nsamples)
    windows = torch.as_tensor(np.asarray(corpus_ids[: n_eff * seqlen]).reshape(n_eff, seqlen),
                              dtype=torch.long).to(params_device(params))
    with torch.no_grad():
        return np.asarray([_window_mean_ce(params, w, config, plan) for w in windows],
                          np.float64)


def windowed_perplexity(params: Params, config: ModelConfig, corpus_ids: np.ndarray,
                        plan: Optional[ModelPlan] = None, seqlen: int = 2048,
                        limit: int = -1) -> float:
    """PPL over non-overlapping windows of ``seqlen`` tokens."""
    mean_ces = windowed_mean_ce(params, config, corpus_ids, plan, seqlen, limit)
    n_eff = len(mean_ces)
    if n_eff == 0:
        logger.info("PPL: nan (no windows)")
        return float("nan")
    # the reference sums mean-CE * seqlen per window
    ppl = float(np.exp(np.sum(mean_ces * seqlen) / (n_eff * seqlen)))
    logger.info("PPL: %s", ppl)
    return ppl


def evaluate_perplexity(params: Params, config: ModelConfig, dataset: np.ndarray,
                        plan: Optional[ModelPlan] = None, limit: int = -1) -> float:
    """Row-wise PPL of a pre-chunked [n, seq] id matrix (input = row[:-1],
    labels = row[1:])."""
    plan = plan or default_plan(config)
    nsamples, seqlen = dataset.shape
    # the reference's loop breaks BEFORE processing row i == limit
    n_eff = nsamples if limit < 0 else min(limit, nsamples)
    if n_eff == 0:
        logger.info("PPL: nan (no rows)")
        return float("nan")
    rows = torch.as_tensor(np.asarray(dataset[:n_eff]), dtype=torch.long).to(
        params_device(params))
    with torch.no_grad():
        mean_ces = np.asarray([_row_mean_ce(params, r, config, plan) for r in rows], np.float64)
    ppl = float(np.exp(np.sum(mean_ces * seqlen) / (n_eff * seqlen)))
    logger.info("PPL: %s", ppl)
    return ppl
