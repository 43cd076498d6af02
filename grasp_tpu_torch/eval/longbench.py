"""LongBench generation evaluation, 21 datasets and a 4-dataset smoke subset
(counterpart of grasp_tpu/eval/longbench.py).

Re-implementation of the reference's LongBench flow
(tools/eval_longbench.py:1-444, itself derived from THUDM/LongBench): the
per-dataset prompt templates and max generation lengths are the canonical
LongBench task definitions (data tables, reproduced for parity); prediction
runs greedy decoding through the port's KV-cache generator with the
reference's middle-truncation rule (:316-322), and scoring
uses the same per-dataset metrics — qa-F1, rouge-L, classification, retrieval,
count, code fuzz-match, and the zh variants (:60-190).

Differences from the reference, deliberate:
  - fuzzywuzzy is unavailable here: fuzz.ratio == round(100 * 2M/T) from
    difflib.SequenceMatcher — implemented directly (identical values);
  - generation goes through grasp_tpu_torch.eval.generate.Generator
    instead of HF model.generate;
  - ``classification_score`` keeps the JAX package's behaviour;
  - datasets load from local disk (datasets/longbench/<name>) — no network.
"""

from __future__ import annotations

import difflib
import json
import logging
import os
import re
import string
from collections import Counter
from typing import Dict, List, Optional, Sequence

import numpy as np

logger = logging.getLogger("grasp_tpu_torch")


# ---------------------------------------------------------------------------
# metrics (reference tools/eval_longbench.py:24-190)
# ---------------------------------------------------------------------------


def normalize_answer(s: str) -> str:
    s = s.lower()
    s = "".join(ch for ch in s if ch not in set(string.punctuation))
    s = re.sub(r"\b(a|an|the)\b", " ", s)
    return " ".join(s.split())


_CN_PUNCT = (
    "！？｡。＂＃＄％＆＇（）＊＋，－／：；＜＝＞＠［＼］＾＿｀｛｜｝～｟｠｢｣､、〃》「」"
    "『』【】〔〕〖〗〘〙〚〛〜〝〞〟〰〾〿–—‘’‛“”„‟…‧﹏."
)


def normalize_zh_answer(s: str) -> str:
    s = s.lower()
    punct = set(string.punctuation + _CN_PUNCT)
    s = "".join(ch for ch in s if ch not in punct)
    return "".join(s.split())


def _fuzz_ratio(a: str, b: str) -> float:
    """fuzzywuzzy fuzz.ratio equivalent: round(100 * SequenceMatcher ratio)."""
    if not a and not b:
        return 100.0
    return round(100 * difflib.SequenceMatcher(None, a, b).ratio())


def count_score(prediction: str, ground_truth: str, **kwargs) -> float:
    numbers = re.findall(r"\d+", prediction)
    if not numbers:
        return 0.0
    right = sum(1 for n in numbers if str(n) == str(ground_truth))
    return right / len(numbers)


def retrieval_score(prediction: str, ground_truth: str, **kwargs) -> float:
    gt_id = re.findall(r"Paragraph (\d+)", ground_truth)[0]
    numbers = re.findall(r"\d+", prediction)
    if not numbers:
        return 0.0
    return sum(1 for n in numbers if str(n) == str(gt_id)) / len(numbers)


def retrieval_zh_score(prediction: str, ground_truth: str, **kwargs) -> float:
    gt_id = re.findall(r"段落(\d+)", ground_truth)[0]
    numbers = re.findall(r"\d+", prediction)
    if not numbers:
        return 0.0
    return sum(1 for n in numbers if str(n) == str(gt_id)) / len(numbers)


def code_sim_score(prediction: str, ground_truth: str, **kwargs) -> float:
    for line in prediction.lstrip("\n").split("\n"):
        if "`" not in line and "#" not in line and "//" not in line:
            prediction = line
            break
    else:
        prediction = ""
    return _fuzz_ratio(prediction, ground_truth) / 100


def classification_score(prediction: str, ground_truth: str, **kwargs) -> float:
    matches = [c for c in kwargs["all_classes"] if c in prediction]
    matches = [m for m in matches if not (m in ground_truth and m != ground_truth)]
    return 1.0 / len(matches) if ground_truth in matches else 0.0


def rouge_score(prediction: str, ground_truth: str, **kwargs) -> float:
    from rouge import Rouge

    try:
        scores = Rouge().get_scores([prediction], [ground_truth], avg=True)
    except Exception:
        return 0.0
    return scores["rouge-l"]["f"]


def rouge_zh_score(prediction: str, ground_truth: str, **kwargs) -> float:
    import jieba

    prediction = " ".join(jieba.cut(prediction, cut_all=False))
    ground_truth = " ".join(jieba.cut(ground_truth, cut_all=False))
    return rouge_score(prediction, ground_truth)


def _f1(pred_tokens: Sequence, gt_tokens: Sequence) -> float:
    common = Counter(pred_tokens) & Counter(gt_tokens)
    num_same = sum(common.values())
    if num_same == 0:
        return 0.0
    precision = num_same / len(pred_tokens)
    recall = num_same / len(gt_tokens)
    return 2 * precision * recall / (precision + recall)


def qa_f1_score(prediction: str, ground_truth: str, **kwargs) -> float:
    return _f1(normalize_answer(prediction).split(), normalize_answer(ground_truth).split())


def qa_f1_zh_score(prediction: str, ground_truth: str, **kwargs) -> float:
    import jieba

    pred = [normalize_zh_answer(t) for t in jieba.cut(prediction, cut_all=False)]
    gt = [normalize_zh_answer(t) for t in jieba.cut(ground_truth, cut_all=False)]
    return _f1([t for t in pred if t], [t for t in gt if t])


DATASET2METRIC = {
    "narrativeqa": qa_f1_score,
    "qasper": qa_f1_score,
    "multifieldqa_en": qa_f1_score,
    "multifieldqa_zh": qa_f1_zh_score,
    "hotpotqa": qa_f1_score,
    "2wikimqa": qa_f1_score,
    "musique": qa_f1_score,
    "dureader": rouge_zh_score,
    "gov_report": rouge_score,
    "qmsum": rouge_score,
    "multi_news": rouge_score,
    "vcsum": rouge_zh_score,
    "trec": classification_score,
    "triviaqa": qa_f1_score,
    "samsum": rouge_score,
    "lsht": classification_score,
    "passage_retrieval_en": retrieval_score,
    "passage_count": count_score,
    "passage_retrieval_zh": retrieval_zh_score,
    "lcc": code_sim_score,
    "repobench-p": code_sim_score,
}

# canonical LongBench task definitions (prompt formats, generation lengths)
# loaded from longbench_tasks.json — data tables from THUDM/LongBench, same
# values the reference embeds at tools/eval_longbench.py:231-276
with open(os.path.join(os.path.dirname(os.path.abspath(__file__)), "longbench_tasks.json")) as _f:
    _TASKS = json.load(_f)

DATASET2PROMPT = _TASKS["dataset2prompt"]
DATASET2MAXLEN = _TASKS["dataset2maxlen"]
FULL_LONGBENCH_DATASETS = list(_TASKS["full_datasets"])
SMALL_LONGBENCH_DATASETS = list(_TASKS["small_datasets"])

# first-line-only postprocess tasks (reference scorer :204, :223)
_FIRST_LINE_TASKS = set(_TASKS["first_line_tasks"])


_VICUNA_SYSTEM = (
    "A chat between a curious user and an artificial intelligence assistant. "
    "The assistant gives helpful, detailed, and polite answers to the user's "
    "questions."
)


def build_chat(prompt: str, model_name: str) -> str:
    """Chat-format wrapper per model family (reference :279-301).

    The reference delegates to each family's toolchain (fastchat conversation
    templates, the ChatGLM tokenizers' build_prompt/build_chat_input); those
    packages aren't importable here, so the wrappers reproduce the exact
    strings those toolchains emit:
      - vicuna/longchat: fastchat "vicuna" template (ADD_COLON_TWO, sep " ")
        -> "<system> USER: <prompt> ASSISTANT:"
      - chatglm (-> chatglm2-6b in the reference's model2path): the
        tokenizer's build_prompt single-turn string
      - chatglm3: build_chat_input's token sequence rendered as text — the
        <|user|>/<|assistant|> role specials are in that family's vocab, so
        encoding with its tokenizer reproduces the reference ids (our
        tokenizer-level approximation; build_chat_input itself returns ids)
    """
    if "chatglm3" in model_name:
        return f"<|user|>\n{prompt}<|assistant|>"
    if "chatglm" in model_name:
        return f"[Round 1]\n\n问：{prompt}\n\n答："
    if "longchat" in model_name or "vicuna" in model_name:
        return f"{_VICUNA_SYSTEM} USER: {prompt} ASSISTANT:"
    if "llama2" in model_name:
        return f"[INST]{prompt}[/INST]"
    if "xgen" in model_name:
        header = (
            "A chat between a curious human and an artificial intelligence assistant. "
            "The assistant gives helpful, detailed, and polite answers to the human's questions.\n\n"
        )
        return header + f" ### Human: {prompt}\n###"
    if "internlm" in model_name:
        return f"<|User|>:{prompt}<eoh>\n<|Bot|>:"
    return prompt


def post_process(response: str, model_name: str) -> str:
    if "xgen" in model_name:
        return response.strip().replace("Assistant:", "")
    if "internlm" in model_name:
        return response.split("<eoa>")[0]
    return response


def scorer(dataset: str, predictions, answers, all_classes) -> float:
    total = 0.0
    for prediction, ground_truths in zip(predictions, answers):
        score = 0.0
        if dataset in _FIRST_LINE_TASKS:
            prediction = prediction.lstrip("\n").split("\n")[0]
        for gt in ground_truths:
            score = max(score, DATASET2METRIC[dataset](prediction, gt, all_classes=all_classes))
        total += score
    return round(100 * total / len(predictions), 2)


def scorer_e(dataset: str, predictions, answers, lengths, all_classes) -> Dict[str, float]:
    scores = {"0-4k": [], "4-8k": [], "8k+": []}
    for prediction, ground_truths, length in zip(predictions, answers, lengths):
        score = 0.0
        if dataset in _FIRST_LINE_TASKS:
            prediction = prediction.lstrip("\n").split("\n")[0]
        for gt in ground_truths:
            score = max(score, DATASET2METRIC[dataset](prediction, gt, all_classes=all_classes))
        bucket = "0-4k" if length < 4000 else ("4-8k" if length < 8000 else "8k+")
        scores[bucket].append(score)
    return {k: round(100 * float(np.mean(v)), 2) if v else 0.0 for k, v in scores.items()}


def middle_truncate(prompt: str, tokenizer, max_length: int) -> str:
    """Keep the first and last max_length/2 tokens (reference :316-322)."""
    ids = tokenizer.encode(prompt, add_special_tokens=False)
    if len(ids) <= max_length:
        return prompt
    half = int(max_length / 2)
    return tokenizer.decode(ids[:half], skip_special_tokens=True) + tokenizer.decode(
        ids[-half:], skip_special_tokens=True
    )


def _load_longbench(dataset: str, data_root: str = ".") -> List[dict]:
    path = os.path.join(data_root, "datasets", "longbench", dataset)
    if os.path.isdir(path):
        from datasets import load_from_disk

        return list(load_from_disk(path))
    raise FileNotFoundError(
        f"LongBench dataset {dataset!r} expected at {path} "
        "(no network in this environment; pass samples_override to eval_longbench)"
    )


def get_pred(
    generator,
    tokenizer,
    data: List[dict],
    max_length: int,
    max_gen: int,
    prompt_format: str,
    dataset: str,
    model_name: str,
    out_path: Optional[str] = None,
    batch_size: int = 8,
) -> List[dict]:
    """Greedy generation with middle truncation (reference :312-366).

    Samples decode in batches of ``batch_size`` through the batched
    generator (Generator.greedy_batch: left-padded rows, per-row RoPE and
    masks); the reference generates one sample at a time (:337-353).
    greedy_batch is held token-identical to Generator.greedy."""
    no_chat = {"trec", "triviaqa", "samsum", "lsht", "lcc", "repobench-p"}
    eos = getattr(tokenizer, "eos_token_id", None)

    prompts: List[np.ndarray] = []
    for json_obj in data:
        prompt = prompt_format.format(**{k: json_obj[k] for k in ("context", "input") if k in json_obj})
        prompt = middle_truncate(prompt, tokenizer, max_length)
        if dataset not in no_chat:
            prompt = build_chat(prompt, model_name)
        prompts.append(np.asarray(tokenizer.encode(prompt, add_special_tokens=True)))

    min_new = 1 if dataset == "samsum" else 0  # reference :336-345
    all_out: List[List[int]] = []
    for start in range(0, len(prompts), batch_size):
        chunk = prompts[start : start + batch_size]
        if len(chunk) == 1:  # avoid a dedicated batch-1 compile
            all_out.append(generator.greedy(chunk[0], max_gen, eos_token_id=eos,
                                            min_new_tokens=min_new))
        else:
            all_out.extend(generator.greedy_batch(chunk, max_gen, eos_token_id=eos,
                                                  min_new_tokens=min_new))

    rsts = []
    nl = tokenizer.encode("\n", add_special_tokens=False)
    for json_obj, ids, out_ids in zip(data, prompts, all_out):
        if dataset == "samsum" and nl:
            # reference :336-345: extra newline stop
            try:
                cut = out_ids.index(nl[-1])
                out_ids = out_ids[:cut]
            except ValueError:
                pass
        pred = post_process(tokenizer.decode(out_ids, skip_special_tokens=True), model_name)
        rst = {
            "pred": pred,
            "answers": json_obj["answers"],
            "all_classes": json_obj.get("all_classes"),
            "length": json_obj.get("length", len(ids)),
        }
        if out_path:
            with open(out_path, "a", encoding="utf-8") as f:
                json.dump(rst, f, ensure_ascii=False)
                f.write("\n")
        rsts.append(rst)
    return rsts


def eval_longbench(
    params,
    config,
    tokenizer,
    model_name: str,
    datasets: Sequence[str],
    plan=None,
    max_length: int = 1024,
    data_root: str = ".",
    output_dir: str = "output",
    samples_override: Optional[Dict[str, List[dict]]] = None,
) -> Dict[str, float]:
    """Full LongBench loop (reference eval_longbench :401-444).

    max_length=1024 matches the reference's hardcoded callsite (:420).
    samples_override injects documents directly (tests / no local data).
    """
    from grasp_tpu_torch.eval.generate import Generator

    generator = Generator(params, config, plan)
    os.makedirs(output_dir, exist_ok=True)
    rsts = {}
    for dataset in datasets:
        data = samples_override[dataset] if samples_override else _load_longbench(dataset, data_root)
        logger.info("Evaluating on %s... (%d samples)", dataset, len(data))
        out_path = os.path.join(output_dir, f"{model_name.split('/')[-1]}_{dataset}_preds.jsonl")
        rsts[dataset] = get_pred(
            generator, tokenizer, data, max_length, DATASET2MAXLEN[dataset],
            DATASET2PROMPT[dataset], dataset, model_name, out_path,
        )

    scores: Dict[str, float] = {}
    for dataset, all_data in rsts.items():
        predictions = [d["pred"] for d in all_data]
        answers = [d["answers"] for d in all_data]
        all_classes = all_data[-1]["all_classes"] if all_data else None
        scores[dataset] = scorer(dataset, predictions, answers, all_classes)
    out_path = os.path.join(output_dir, f"{model_name.split('/')[-1]}_result.json")
    with open(out_path, "a") as f:
        json.dump(scores, f, ensure_ascii=False, indent=4)
    logger.info("LongBench scores: %s", scores)
    return scores
