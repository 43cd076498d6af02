"""Zero/few-shot evaluation harness (counterpart of grasp_tpu/eval/harness.py).

The reference adapts its model to lm-eval 0.3.0's BaseLM and calls
``evaluator.simple_evaluate``. lm-eval is not a dependency, so the harness is
implemented natively with the same request semantics:

  - multiple-choice tasks are scored by the summed token log-likelihood of
    each continuation given its context (lm-eval ``loglikelihood``),
    prediction = argmax, metric = accuracy ("acc");
  - context + continuation is tokenized as one sequence, the continuation's
    tokens found by tokenizing the context alone (lm-eval 0.3.0);
  - inputs longer than max_length keep their last max_length tokens.

Evaluation-loop fidelity to lm-eval 0.3.0's evaluator.evaluate:

  - documents are SHUFFLED with random.Random(42) before ``limit`` applies,
    so a limited run scores a seeded random subset, not the first N rows;
  - few-shot examples come from the task's TRAINING split when one exists
    (rnd.sample(training_docs, k) with the same rnd); otherwise k + 1 are
    sampled from the eval docs, the current doc dropped and the first k kept;
  - shots are formatted "<context><gold continuation>" joined by "\\n\\n",
    with a trailing "\\n\\n" before the scored doc's context;
  - acc_norm (log-likelihood over the continuation's UTF-8 byte length) is
    reported for the tasks that define it in 0.3.0 (piqa, hellaswag, arc_*,
    openbookqa, mathqa); boolq and winogrande have acc only. The "mean"
    aggregate averages plain acc, as the reference does.

Task formats follow lm-eval 0.3.0 for the reference's default task list:
boolq, piqa, hellaswag, winogrande, arc_easy, arc_challenge, openbookqa,
mathqa. Datasets load from local disk (datasets/<name>/<split>), never from
the network.

A scoring batch is one forward of [B <= batch_size, S] rows right-padded to a
multiple of 128, with no padding mask (causality keeps the pads out of every
scored position): on CUDA it takes the flash-attention kernel when the config
asks for it, one launch a layer a batch.
"""

from __future__ import annotations

import logging
import os
import re
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from grasp_tpu_torch.configs import ModelConfig
from grasp_tpu_torch.eval.ppl import params_device
from grasp_tpu_torch.models.llama import ModelPlan, Params, default_plan, forward

logger = logging.getLogger("grasp_tpu_torch")

_BUCKET = 128


def _round_up(x, m):
    return ((x + m - 1) // m) * m


class EvalLM:
    """Log-likelihood scorer over (context, continuation) requests: the
    reference's EvalLM(BaseLM) adapter for the functional model."""

    def __init__(self, params: Params, config: ModelConfig, tokenizer,
                 plan: Optional[ModelPlan] = None, batch_size: int = 8,
                 max_length: Optional[int] = None):
        self.params = params
        self.config = config
        self.plan = plan or default_plan(config)
        self.tokenizer = tokenizer
        self.batch_size = batch_size
        self.max_length = max_length or config.max_position_embeddings
        self.seqlen = 2048  # the reference's
        self.device = params_device(params)

    # -- tokenization ------------------------------------------------------
    def tok_encode(self, s: str) -> List[int]:
        return self.tokenizer.encode(s, add_special_tokens=False)

    # -- scoring -----------------------------------------------------------
    def loglikelihood(self, requests: Sequence[Tuple[str, str]]) -> List[Tuple[float, bool]]:
        """[(context, continuation)] -> [(sum logp of continuation, is_greedy)]."""
        results: List[Optional[Tuple[float, bool]]] = [None] * len(requests)
        prepared = []
        for i, (context, continuation) in enumerate(requests):
            ctx_ids = self.tok_encode(context)
            full_ids = self.tok_encode(context + continuation)
            cont_ids = full_ids[len(ctx_ids):]
            if not cont_ids:  # tokenizer merged the boundary; fall back
                cont_ids = self.tok_encode(continuation)
                full_ids = ctx_ids + cont_ids
            # BOS like lm-eval: prepend eot/bos so an empty context still scores
            bos = getattr(self.tokenizer, "bos_token_id", None)
            if bos is None:
                bos = getattr(self.tokenizer, "eos_token_id", 0)
            full_ids = [bos] + full_ids
            full_ids = full_ids[-self.max_length:]
            prepared.append((i, full_ids, len(cont_ids)))

        # bucket by padded length, batch within buckets
        prepared.sort(key=lambda t: len(t[1]))
        return self._score(prepared, results)

    @torch.no_grad()
    def _score(self, prepared, results):
        """Score ``prepared`` (index, ids, continuation length) in batches of
        ``batch_size`` rows right-padded to a multiple of 128: the summed fp32
        log-softmax of each continuation token and whether every one is the
        argmax."""
        for start in range(0, len(prepared), self.batch_size):
            chunk = prepared[start: start + self.batch_size]
            s_pad = _round_up(max(len(ids) for _, ids, _ in chunk), _BUCKET)
            batch = torch.zeros((len(chunk), s_pad), dtype=torch.long)
            for row, (_, ids, _) in enumerate(chunk):
                batch[row, : len(ids)] = torch.as_tensor(ids, dtype=torch.long)
            logits = forward(self.params, batch.to(self.device), config=self.config,
                             plan=self.plan)["logits"]
            for row, (i, ids, n_cont) in enumerate(chunk):
                L = len(ids)
                # the logits at p predict the token at p + 1
                logp = torch.log_softmax(logits[row, L - n_cont - 1: L - 1].float(), dim=-1)
                tgt = torch.as_tensor(ids[L - n_cont:], dtype=torch.long, device=logp.device)
                token_logp = logp.gather(-1, tgt[:, None])[:, 0]
                greedy = bool((logp.argmax(-1) == tgt).all())
                results[i] = (float(token_logp.sum()), greedy)
        return results  # type: ignore[return-value]

    def loglikelihood_rolling(self, texts: Sequence[str]) -> List[float]:
        """lm-eval 0.3.0 ``loglikelihood_rolling`` equivalent: total logprob
        of each full text, scored in max_length windows so every token is
        predicted exactly once with at least one token of context (BOS for
        the first window, the preceding token after — 0.3.0's
        ``get_rolling_token_windows(context_len=1)`` scheme; our windows
        predict up to max_length-1 tokens each so the model input never
        exceeds max_length, a one-token-per-window layout difference that
        does not change which tokens are scored or on how much context).

        All windows of all texts are batched through the same bucketed
        ``_score`` path as ordinary loglikelihood requests."""
        bos = getattr(self.tokenizer, "bos_token_id", None)
        if bos is None:
            bos = getattr(self.tokenizer, "eos_token_id", 0)
        M = self.max_length
        prepared: List[Tuple[int, List[int], int]] = []
        owners: List[int] = []  # request index -> text index
        for ti, text in enumerate(texts):
            toks = self.tok_encode(text)
            j = 0
            while j < len(toks):
                n = min(len(toks) - j, M - 1)
                if j == 0:
                    ids = [bos] + toks[:n]
                else:
                    ids = toks[j - 1 : j + n]  # one token of rolled context
                prepared.append((len(owners), ids, n))
                owners.append(ti)
                j += n
        prepared.sort(key=lambda t: len(t[1]))
        results: List[Optional[Tuple[float, bool]]] = [None] * len(owners)
        self._score(prepared, results)
        totals = [0.0] * len(texts)
        for i, ti in enumerate(owners):
            totals[ti] += results[i][0]
        return totals

    # -- generation ----------------------------------------------------------
    @property
    def max_gen_toks(self) -> int:
        return 256  # reference evaluate_grasp.py:65-66

    def greedy_until(self, requests: Sequence[Tuple[str, Sequence[str]]]) -> List[str]:
        """lm-eval BaseLM.greedy_until equivalent: generate until any stop
        string (or max_gen_toks), returning the decoded continuations.

        Requests decode ``batch_size`` at a time through the batched
        generator (left-padded rows); a chunk of one takes the single-prompt
        path. Stop STRINGS are applied to the decoded text of each request
        (they are request-specific)."""
        from grasp_tpu_torch.eval.generate import Generator

        if not hasattr(self, "_generator"):
            self._generator = Generator(self.params, self.config, self.plan)
        eos = getattr(self.tokenizer, "eos_token_id", None)

        prompts = [
            np.asarray(self.tok_encode(context)[-(self.max_length - self.max_gen_toks):],
                       np.int32)
            for context, _ in requests
        ]
        all_ids: List[List[int]] = []
        for start in range(0, len(prompts), self.batch_size):
            chunk = prompts[start : start + self.batch_size]
            if len(chunk) == 1:
                all_ids.append(self._generator.greedy(chunk[0], self.max_gen_toks,
                                                      eos_token_id=eos))
            else:
                all_ids.extend(self._generator.greedy_batch(chunk, self.max_gen_toks,
                                                            eos_token_id=eos))

        outs = []
        for (_, stops), new_ids in zip(requests, all_ids):
            text = self.tokenizer.decode(new_ids, skip_special_tokens=True)
            for stop in stops or []:
                idx = text.find(stop)
                if idx >= 0:
                    text = text[:idx]
            outs.append(text)
        return outs


# ---------------------------------------------------------------------------
# Task registry (lm-eval 0.3.0 formats)
# ---------------------------------------------------------------------------


class Task:
    name: str = ""
    split_candidates = ("validation", "test")
    has_acc_norm = True  # lm-eval 0.3.0 default for multiple_choice tasks

    def docs(self, data_root: str = ".") -> List[dict]:
        from datasets import load_from_disk

        for split in self.split_candidates:
            path = os.path.join(data_root, "datasets", self.name, split)
            if os.path.isdir(path):
                return list(load_from_disk(path))
        raise FileNotFoundError(
            f"task {self.name!r}: no local dataset under datasets/{self.name}/"
            f"{{{','.join(self.split_candidates)}}} (no network in this environment)"
        )

    def train_docs(self, data_root: str = ".") -> Optional[List[dict]]:
        """The task's training split when present locally (few-shot source,
        lm-eval 0.3.0 Task.fewshot_examples); None otherwise."""
        from datasets import load_from_disk

        path = os.path.join(data_root, "datasets", self.name, "train")
        if os.path.isdir(path):
            return list(load_from_disk(path))
        return None

    def context(self, doc: dict) -> str:
        raise NotImplementedError

    def choices(self, doc: dict) -> List[str]:
        raise NotImplementedError

    def gold(self, doc: dict) -> int:
        raise NotImplementedError

    def fewshot_context(self, doc: dict, shots: List[dict]) -> str:
        """lm-eval 0.3.0 format: "<text><target>" shots joined by "\\n\\n",
        trailing "\\n\\n", then the scored doc's context."""
        if not shots:
            return self.context(doc)
        labeled = "\n\n".join(self.context(s) + self.choices(s)[self.gold(s)] for s in shots)
        return labeled + "\n\n" + self.context(doc)


class BoolQ(Task):
    name = "boolq"
    has_acc_norm = False  # lm-eval 0.3.0 boolq reports acc only

    def context(self, doc):
        return f"{doc['passage']}\nQuestion: {doc['question']}?\nAnswer:"

    def choices(self, doc):
        return [" no", " yes"]

    def gold(self, doc):
        return int(bool(doc["answer"]))


class PIQA(Task):
    name = "piqa"

    def context(self, doc):
        return f"Question: {doc['goal']}\nAnswer:"

    def choices(self, doc):
        return [" " + doc["sol1"], " " + doc["sol2"]]

    def gold(self, doc):
        return int(doc["label"])


def _hellaswag_preprocess(text: str) -> str:
    text = text.strip().replace(" [title]", ". ")
    text = re.sub(r"\[.*?\]", "", text)
    return text.replace("  ", " ")


class HellaSwag(Task):
    name = "hellaswag"

    def context(self, doc):
        ctx = doc["ctx_a"] + " " + doc["ctx_b"].capitalize()
        return _hellaswag_preprocess(doc["activity_label"] + ": " + ctx)

    def choices(self, doc):
        return [" " + _hellaswag_preprocess(e) for e in doc["endings"]]

    def gold(self, doc):
        return int(doc["label"])


class Winogrande(Task):
    """Partial-evaluation format (lm-eval 0.3.0 winogrande): the option fills
    the blank into the context; the scored continuation is the sentence suffix
    after the blank. Few-shot follows 0.3.0's append_context exactly — the
    doc's own text in the few-shot context carries the GOLD option, and
    construct_requests pops that final "\\n\\n" segment before substituting
    each candidate option."""

    name = "winogrande"
    has_acc_norm = False  # lm-eval 0.3.0 winogrande reports acc only

    def partial_context(self, doc, option: str) -> str:
        idx = doc["sentence"].index("_")
        return doc["sentence"][:idx] + option

    def partial_target(self, doc) -> str:
        idx = doc["sentence"].index("_")
        return " " + doc["sentence"][idx + 1 :].strip()

    def context(self, doc):  # 0.3.0 doc_to_text: gold option filled in
        return self.partial_context(doc, self.choices(doc)[self.gold(doc)])

    def choices(self, doc):
        return [doc["option1"], doc["option2"]]

    def gold(self, doc):
        return int(doc["answer"]) - 1

    def fewshot_context(self, doc: dict, shots: List[dict]) -> str:
        parts = [
            self.partial_context(s, self.choices(s)[self.gold(s)]) + self.partial_target(s)
            for s in shots
        ]
        parts.append(self.context(doc))
        return "\n\n".join(parts)

    def requests(self, ctx: str, doc: dict) -> List[Tuple[str, str]]:
        # 0.3.0 append_context: drop the final "\n\n" segment (the gold-filled
        # doc_to_text) and splice in each option's partial context
        target = self.partial_target(doc)
        segs = ctx.split("\n\n")[:-1]
        out = []
        for opt in self.choices(doc):
            pc = self.partial_context(doc, opt)
            out.append(("\n\n".join([*segs, pc]) if segs else pc, target))
        return out


class ARCEasy(Task):
    name = "arc_easy"

    def context(self, doc):
        return f"Question: {doc['question']}\nAnswer:"

    def choices(self, doc):
        return [" " + t for t in doc["choices"]["text"]]

    def gold(self, doc):
        return doc["choices"]["label"].index(doc["answerKey"])


class ARCChallenge(ARCEasy):
    name = "arc_challenge"


class OpenBookQA(Task):
    name = "openbookqa"

    def context(self, doc):
        return doc["question_stem"]

    def choices(self, doc):
        return [" " + t for t in doc["choices"]["text"]]

    def gold(self, doc):
        return doc["choices"]["label"].index(doc["answerKey"])


class MathQA(Task):
    name = "mathqa"

    def context(self, doc):
        return f"Question: {doc['Problem']}\nAnswer:"

    def choices(self, doc):
        opts = [
            c[4:].rstrip(" ,")
            for c in re.findall(r"[abcd] \) .*?, |e \) .*?$", doc["options"])
        ]
        return [" " + o for o in opts]

    def gold(self, doc):
        return ["a", "b", "c", "d", "e"].index(doc["correct"])


TASK_REGISTRY: Dict[str, Task] = {
    t.name: t
    for t in [BoolQ(), PIQA(), HellaSwag(), Winogrande(), ARCEasy(), ARCChallenge(), OpenBookQA(), MathQA()]
}


def _register_from_spec_library(task_name: str) -> None:
    """Lazily register a task from the shipped spec library
    (eval/task_specs.json) if it defines ``task_name``; no-op otherwise."""
    import json

    path = os.path.join(os.path.dirname(os.path.abspath(__file__)), "task_specs.json")
    try:
        with open(path) as f:
            specs = json.load(f)
    except OSError:
        return
    for spec in specs if isinstance(specs, list) else [specs]:
        if spec.get("name") == task_name:
            from grasp_tpu_torch.eval.task_spec import register_task_spec

            register_task_spec(spec)
            return


def _fewshot_docs(task: Task, doc: dict, num_fewshot: int, rnd,
                  train_pool: Optional[List[dict]], eval_pool: List[dict]) -> List[dict]:
    """lm-eval 0.3.0 shot selection: rnd.sample from the training docs when a
    train split exists; else sample k+1 eval docs, drop the current doc, keep
    the first k. ``rnd`` is the SAME random.Random(42) that shuffled the docs,
    consumed in document order."""
    if train_pool:
        return rnd.sample(train_pool, min(num_fewshot, len(train_pool)))
    k = min(num_fewshot + 1, len(eval_pool))
    sampled = rnd.sample(eval_pool, k)
    return [d for d in sampled if d != doc][:num_fewshot]


def evaluate_tasks(
    lm: EvalLM,
    tasks: Sequence[str],
    num_fewshot: int = 0,
    limit: Optional[int] = None,
    data_root: str = ".",
    docs_override: Optional[Dict[str, List[dict]]] = None,
    seed: int = 42,
) -> Dict[str, Dict[str, float]]:
    """simple_evaluate equivalent: {"<task>": {"acc", "acc_norm"}, "mean"}.

    Faithful to lm-eval 0.3.0's evaluator.evaluate (see module docstring):
    docs shuffled by random.Random(42) before ``limit``; few-shot drawn from
    the training split via the same rnd; acc_norm = argmax of loglikelihood /
    continuation UTF-8 byte length for tasks that define it. "mean" averages
    plain acc like the reference (evaluate_grasp.py:231-235).

    docs_override lets tests inject documents without local datasets
    (use key "<task>:train" to inject a training split for few-shot).
    """
    import random

    results: Dict[str, Any] = {}
    for task_name in tasks:
        if task_name not in TASK_REGISTRY:
            # fall back to the shipped declarative spec library (lambada
            # family lives there; the 8 defaults are hand classes) — keeps
            # the reference's "any 0.3.0 task name" surface open for tasks
            # that are data-definable (evaluate_grasp.py:222-229)
            _register_from_spec_library(task_name)
        if task_name not in TASK_REGISTRY:
            raise KeyError(f"unknown task {task_name!r}; available: {sorted(TASK_REGISTRY)}")
        task = TASK_REGISTRY[task_name]
        if docs_override:
            all_docs = list(docs_override[task_name])
            train_pool = docs_override.get(f"{task_name}:train")
        else:
            all_docs = task.docs(data_root)
            train_pool = task.train_docs(data_root) if num_fewshot > 0 else None

        rnd = random.Random()
        rnd.seed(seed)
        docs = list(all_docs)
        rnd.shuffle(docs)
        if limit and limit > 0:
            docs = docs[:limit]

        if getattr(task, "rolling", False):
            # loglikelihood_rolling task (wikitext-style): whole-document
            # logprob, aggregated as 0.3.0's weighted perplexities —
            # word_perplexity = exp(-sum ll / sum words), byte_perplexity
            # likewise over UTF-8 bytes, bits_per_byte = -sum ll /
            # (bytes * ln 2). No acc: rolling tasks don't enter "mean",
            # matching the reference's acc-only aggregation
            # (evaluate_grasp.py:231-235). Few-shot context doesn't apply
            # (0.3.0 scores rolling requests with an empty context).
            texts = [task.text(doc) for doc in docs]
            lls = lm.loglikelihood_rolling(texts)
            total = float(np.sum(lls)) if texts else 0.0
            words = sum(task.count_words(t) for t in texts)
            nbytes = sum(task.count_bytes(t) for t in texts)
            results[task_name] = {
                "word_perplexity": float(np.exp(-total / max(words, 1))),
                "byte_perplexity": float(np.exp(-total / max(nbytes, 1))),
                "bits_per_byte": float(-total / (max(nbytes, 1) * np.log(2))),
            }
            logger.info("%s %s (%d docs)", task_name, results[task_name], len(docs))
            continue

        if getattr(task, "generation", False):
            # greedy_until task (declarative spec, eval/task_spec.py): score
            # generations with the task's match rule, report as "acc" so the
            # mean aggregation applies unchanged
            ctxs = []
            for doc in docs:
                if num_fewshot > 0:
                    shots = _fewshot_docs(task, doc, num_fewshot, rnd, train_pool, all_docs)
                    ctxs.append(task.fewshot_context(doc, shots))
                else:
                    ctxs.append(task.context(doc))
            gens = lm.greedy_until([(c, list(task.stops)) for c in ctxs])
            # float() not bool(): spec tasks return booleans (exact/contains
            # match -> 1.0/0.0, unchanged), wrapped 0.3.0 tasks may return a
            # fractional per-doc metric (F1, token-level EM) that must
            # average, not round up
            hits = sum(float(task.score(g, doc)) for g, doc in zip(gens, docs))
            results[task_name] = {"acc": hits / max(len(docs), 1)}
            logger.info("%s %s (%d docs)", task_name, results[task_name], len(docs))
            continue

        if getattr(task, "loglik", False):
            # single-continuation task (lambada family, eval/task_spec.py):
            # acc = 0.3.0's is_greedy fraction, ppl = exp(-mean ll) (0.3.0's
            # perplexity aggregation)
            reqs = []
            for doc in docs:
                if num_fewshot > 0:
                    shots = _fewshot_docs(task, doc, num_fewshot, rnd, train_pool, all_docs)
                    ctx = task.fewshot_context(doc, shots)
                else:
                    ctx = task.context(doc)
                reqs.append((ctx, task.target(doc)))
            lls = lm.loglikelihood(reqs)
            n = max(len(docs), 1)
            results[task_name] = {
                "acc": sum(int(g) for _, g in lls) / n,
                "ppl": float(np.exp(-np.mean([ll for ll, _ in lls]))) if docs else 0.0,
            }
            logger.info("%s %s (%d docs)", task_name, results[task_name], len(docs))
            continue

        requests: List[Tuple[str, str]] = []
        spans: List[Tuple[int, int, int]] = []  # (start, n_choices, gold)
        for doc in docs:
            if num_fewshot > 0:
                shots = _fewshot_docs(task, doc, num_fewshot, rnd, train_pool, all_docs)
                ctx = task.fewshot_context(doc, shots)
            else:
                ctx = task.context(doc)
            if hasattr(task, "requests"):  # partial-evaluation (winogrande-style)
                reqs = task.requests(ctx, doc)
            else:
                reqs = [(ctx, cont) for cont in task.choices(doc)]
            spans.append((len(requests), len(reqs), task.gold(doc)))
            requests.extend(reqs)

        lls = lm.loglikelihood(requests)
        correct = 0
        correct_norm = 0
        for (start, n, gold), doc in zip(spans, docs):
            scores = [lls[start + j][0] for j in range(n)]
            if int(np.argmax(scores)) == gold:
                correct += 1
            if task.has_acc_norm:
                lens = [max(len(c.encode("utf-8")), 1) for c in task.choices(doc)]
                normed = [s / b for s, b in zip(scores, lens)]
                if int(np.argmax(normed)) == gold:
                    correct_norm += 1
        acc = correct / max(len(spans), 1)
        results[task_name] = {"acc": acc}
        if task.has_acc_norm:
            results[task_name]["acc_norm"] = correct_norm / max(len(spans), 1)
        logger.info("%s %s (%d docs)", task_name, results[task_name], len(spans))

    # rolling tasks report perplexities, not acc — they don't enter "mean",
    # matching the reference's acc-only aggregation (evaluate_grasp.py:231-235)
    accs = [v["acc"] for v in results.values()
            if isinstance(v, dict) and "acc" in v]
    results["mean"] = float(np.mean(accs)) if accs else 0.0
    return results
