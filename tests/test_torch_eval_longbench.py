"""The port's LongBench evaluation against the JAX package: every metric,
``scorer``/``scorer_e``, ``build_chat``, ``post_process`` and
``middle_truncate`` on fixed strings, its own copy of the task table, and
``eval_longbench`` end to end on the same weights (``samples_override``):
the same predictions, files and scores.
"""

import json
import os

import jax
import pytest

from grasp_tpu.data.tokenizer import ByteTokenizer as JByteTokenizer
from grasp_tpu.eval import longbench as jlb
from grasp_tpu.models.llama import default_plan
from grasp_tpu_torch.data.tokenizer import ByteTokenizer
from grasp_tpu_torch.eval import longbench as tlb
from torch_parity import (grasp_compressed, one_torch_thread, port_config,  # noqa: F401
                          small_config, to_port)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

PAIRS = [("the Quick brown fox!", "a quick brown fox"), ("42 paragraphs in total, maybe 7", "7"),
         ("answer: Paragraph 12", "Paragraph 12 says things"), ("", "anything"),
         ("x = 1\n# comment\ny = 2", "x = 1"), ("猫是动物", "猫是一种动物"),
         ("段落3 和 段落 4", "段落3"), ("label A or AB", "AB")]
CLASSES = ["A", "AB", "C"]
MODEL_NAMES = ["llama2-7b-chat-4k", "chatglm2-6b", "chatglm3-6b-32k", "vicuna-v1.5-7b-16k",
               "longchat-v1.5-7b-32k", "internlm-7b-8k", "xgen-7b-8k", "some-base-model"]


def test_task_table_is_the_port_s_own_copy():
    with open(os.path.join(ROOT, "grasp_tpu_torch", "eval", "longbench_tasks.json")) as f, \
            open(os.path.join(ROOT, "grasp_tpu", "eval", "longbench_tasks.json")) as g:
        assert json.load(f) == json.load(g)
    assert (tlb.FULL_LONGBENCH_DATASETS, tlb.SMALL_LONGBENCH_DATASETS) == (
        jlb.FULL_LONGBENCH_DATASETS, jlb.SMALL_LONGBENCH_DATASETS)
    assert tlb.DATASET2PROMPT == jlb.DATASET2PROMPT and tlb.DATASET2MAXLEN == jlb.DATASET2MAXLEN
    assert sorted(tlb.DATASET2METRIC) == sorted(jlb.DATASET2METRIC)


def test_metrics_and_scorers_equal_jax():
    for name in sorted(tlb.DATASET2METRIC):
        fn, jfn = tlb.DATASET2METRIC[name], jlb.DATASET2METRIC[name]
        for pred, gt in PAIRS:
            if "retrieval" in name and not any(k in gt for k in ("Paragraph", "段落")):
                continue  # a retrieval answer always names its paragraph
            gt = {"passage_retrieval_en": "Paragraph 12", "passage_retrieval_zh": "段落3"}.get(
                name, gt)
            assert fn(pred, gt, all_classes=CLASSES) == jfn(pred, gt, all_classes=CLASSES), \
                (name, pred, gt)
    preds = ["a quick fox", "7\nmore lines", "\nAB first", "C"]
    answers = [["the quick fox"], ["7"], ["AB", "A"], ["C"]]
    lengths = [100, 5000, 9000, 3999]
    for name in ("narrativeqa", "trec", "samsum", "passage_count", "lcc"):
        assert tlb.scorer(name, preds, answers, CLASSES) == jlb.scorer(name, preds, answers,
                                                                       CLASSES)
        assert tlb.scorer_e(name, preds, answers, lengths, CLASSES) == jlb.scorer_e(
            name, preds, answers, lengths, CLASSES)


def test_chat_post_process_and_truncation_equal_jax():
    tok, jtok = ByteTokenizer(), JByteTokenizer()
    for name in MODEL_NAMES:
        for p in ("What is 2+2?", "line one\nline two"):
            assert tlb.build_chat(p, name) == jlb.build_chat(p, name)
        for r in ("  Assistant: yes<eoa> tail", "plain"):
            assert tlb.post_process(r, name) == jlb.post_process(r, name)
    for text, n in (("short", 64), ("x" * 50 + "middle" + "y" * 50, 20), ("ünïcode " * 9, 11)):
        assert tlb.middle_truncate(text, tok, n) == jlb.middle_truncate(text, jtok, n)


def test_eval_longbench_equals_jax(tmp_path):
    """trec (no chat template, classification), samsum (one new token at
    least, cut at a newline) and a dataset of one sample (the single-prompt
    path), on a GRASP-compressed model."""
    config = small_config(vocab_size=260, max_position_embeddings=512)
    jp, plan = grasp_compressed(config)
    samples = {
        "trec": [{"context": f"Question: what is {w}?\nType: Entity\n", "input": f"why {w}",
                  "answers": ["Entity"], "all_classes": ["Entity", "Location", "Number"],
                  "length": 40} for w in ("salt", "iron", "a longer question about rivers")],
        "samsum": [{"context": "A: hi\nB: hello there\n", "input": "A: bye",
                    "answers": ["They greet."], "length": 20},
                   {"context": "C: lunch?\nD: yes\n" * 5, "input": "C: ok",
                    "answers": ["They plan lunch."], "length": 90}],
        "passage_count": [{"context": "Paragraph 1: a\nParagraph 2: b\n", "input": "",
                           "answers": ["2"], "length": 30}],
    }
    names = list(samples)
    want = jlb.eval_longbench(jp, config, JByteTokenizer(vocab_size=260), "org/m-chat", names,
                              plan=plan, max_length=200, output_dir=str(tmp_path / "jax"),
                              samples_override=samples)
    got = tlb.eval_longbench(to_port(jp), port_config(config), ByteTokenizer(vocab_size=260),
                             "org/m-chat", names, plan=plan, max_length=200,
                             output_dir=str(tmp_path / "port"), samples_override=samples)
    assert got == want and set(got) == set(names)
    for name in names:
        with open(tmp_path / "port" / f"m-chat_{name}_preds.jsonl") as f, \
                open(tmp_path / "jax" / f"m-chat_{name}_preds.jsonl") as g:
            rows = [json.loads(line) for line in f]
            assert rows == [json.loads(line) for line in g]
        assert len(rows) == len(samples[name])
    assert default_plan(config) != plan
