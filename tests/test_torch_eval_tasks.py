"""The port's declarative task specs (eval/task_spec.py, its own
task_specs.json) and lm-eval ingestion (eval/lm_eval_compat.py) behave as
the JAX package's: every shipped spec and every spec type renders the same
contexts, choices, golds, targets and scores; the fake lm-eval 0.3.0 tasks of
tests/test_lm_eval_compat.py wrap identically; 0.4 YAML configs convert to
the same specs and fail with the same errors; and spec and wrapped tasks
evaluate on the model to the same result dicts.
"""

import json
import os

import jax
import pytest

from grasp_tpu.data.tokenizer import ByteTokenizer as JByteTokenizer
from grasp_tpu.eval import harness as jharness
from grasp_tpu.eval import lm_eval_compat as jcompat
from grasp_tpu.eval import task_spec as jspec
from grasp_tpu.models import init_params
from grasp_tpu_torch.data.tokenizer import ByteTokenizer
from grasp_tpu_torch.eval import harness as tharness
from grasp_tpu_torch.eval import lm_eval_compat as tcompat
from grasp_tpu_torch.eval import task_spec as tspec
from test_lm_eval_compat import (Fake030GenTask, Fake030LoglikTask, Fake030MCTask,
                                 Fake030RollingTask)
from test_task_spec import DOCS
from torch_parity import one_torch_thread, port_config, small_config, to_port  # noqa: F401

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

EXTRA_SPECS = [
    {"name": "t_copa", "type": "multiple_choice", "context": "{premise} because",
     "choices": {"fields": ["choice1", "choice2"], "prefix": " "}, "gold": {"field": "label"}},
    {"name": "t_static", "type": "multiple_choice", "context": "Q: {q}\nA:",
     "choices": {"static": [" alpha", " beta"]}, "gold": {"static": 1},
     "context_postprocess": "hellaswag"},
    {"name": "t_gen", "type": "generation", "context": "say: {q}", "target": {"field": "answer"},
     "stops": ["\n"], "match": "contains"},
    {"name": "t_roll", "type": "loglikelihood_rolling", "text": {"field": "page"}},
]
EXTRA_DOC = {"premise": "it rained [x]", "choice1": "clouds", "choice2": "sun", "label": 1,
             "q": "what [title] is it", "answer": "it", "page": "a b  c\nd"}


def _render(task, doc):
    """Everything a task exposes for one doc, as plain data."""
    out = {"context": task.context(doc), "choices": task.choices(doc), "gold": task.gold(doc),
           "has_acc_norm": task.has_acc_norm, "split_candidates": task.split_candidates}
    if not getattr(task, "rolling", False):  # a rolling task has no choices to label shots
        out["fewshot"] = task.fewshot_context(doc, [doc, doc])
    for name in ("generation", "loglik", "rolling", "stops"):
        out[name] = getattr(task, name, None)
    if hasattr(task, "requests"):
        out["requests"] = task.requests(out["fewshot"], doc)
    if hasattr(task, "target"):
        out["target"] = task.target(doc)
    if hasattr(task, "text"):
        out["text"] = task.text(doc)
        out["counts"] = (task.count_words(out["text"]), task.count_bytes(out["text"]))
    if getattr(task, "generation", False):
        out["scores"] = [task.score(g, doc) for g in (" it", "no", doc.get("answer", ""))]
    return out


def test_spec_library_is_the_port_s_own_copy_and_renders_as_jax():
    port_path = os.path.join(ROOT, "grasp_tpu_torch", "eval", "task_specs.json")
    jax_path = os.path.join(ROOT, "grasp_tpu", "eval", "task_specs.json")
    with open(port_path) as f, open(jax_path) as g:
        specs = json.load(f)
        assert specs == json.load(g)
    lambada_doc = {"text": "the quick brown fox jumps over the lazy dog"}
    for spec in specs + EXTRA_SPECS:
        doc = DOCS.get(spec["name"], lambada_doc if "lambada" in spec["name"] else EXTRA_DOC)
        assert _render(tspec.make_task(spec), doc) == _render(jspec.make_task(spec), doc), \
            spec["name"]
    with pytest.raises(ValueError, match="unknown task spec type"):
        tspec.make_task({"name": "x", "type": "nope"})


def test_load_task_specs_registers_in_the_port_only(tmp_path):
    path = tmp_path / "specs.json"
    path.write_text(json.dumps(EXTRA_SPECS[:2]))
    try:
        assert tspec.load_task_specs(str(path)) == ["t_copa", "t_static"]
        assert {"t_copa", "t_static"} <= set(tharness.TASK_REGISTRY)
        assert not {"t_copa", "t_static"} & set(jharness.TASK_REGISTRY)
        assert isinstance(tharness.TASK_REGISTRY["t_copa"], tharness.Task)
    finally:
        for name in ("t_copa", "t_static"):
            tharness.TASK_REGISTRY.pop(name, None)


def test_wrapped_030_tasks_behave_as_jax():
    mc = (tcompat.wrap_lm_eval_task(Fake030MCTask(), "fake_piqa"),
          jcompat.wrap_lm_eval_task(Fake030MCTask(), "fake_piqa"))
    docs = mc[0].docs()
    assert docs == mc[1].docs() and len(docs) == 2
    assert _render(mc[0], docs[0]) == _render(mc[1], docs[0])
    assert mc[0].fewshot_context(docs[1], [docs[0]]) == mc[1].fewshot_context(docs[1], [docs[0]])
    assert isinstance(mc[0], tharness.Task)
    cases = ((Fake030GenTask, [{"q": "color of snow", "answer": "white"}]),
             (Fake030LoglikTask, [{"text": "the sky is blue"}]),
             (Fake030RollingTask, [{"page": "one two  three"}]))
    for cls, task_docs in cases:
        got = tcompat.wrap_lm_eval_task(cls(task_docs), "w")
        want = jcompat.wrap_lm_eval_task(cls(task_docs), "w")
        assert _render(got, task_docs[0]) == _render(want, task_docs[0]), cls.__name__
    gen = tcompat.wrap_lm_eval_task(Fake030GenTask(cases[0][1]), "w")
    assert [gen.score(g, cases[0][1][0]) for g in (" white", " white snow", " black")] == [
        1.0, 0.5, 0.0]

    class NoDocToText:
        pass

    with pytest.raises(TypeError, match="doc_to_text"):
        tcompat.wrap_lm_eval_task(NoDocToText(), "bad")


YAML_CONFIGS = [
    {"task": "piqa_yaml", "output_type": "multiple_choice",
     "doc_to_text": "Question: {{goal}}\nAnswer:", "doc_to_choice": "{{endings}}",
     "doc_to_target": "{{label}}", "validation_split": "validation"},
    {"task": "yn", "doc_to_text": "{{question}}?", "doc_to_choice": [" no", " yes"],
     "doc_to_target": 1},
    {"task": "qa_gen", "output_type": "generate_until", "doc_to_text": "Q: {{question}}\nA:",
     "doc_to_target": "{{answer}}", "generation_kwargs": {"until": ["\n"]},
     "test_split": "test"},
    {"task": "wikitext_like", "output_type": "loglikelihood_rolling", "doc_to_text": "",
     "doc_to_target": "{{page}}", "test_split": "test"},
]
_BASE = {"task": "t", "doc_to_text": "{{q}}", "doc_to_choice": [" a"], "doc_to_target": 0}
BAD_YAML = [{**_BASE, "doc_to_text": "{{q | upper}}"},
            {**_BASE, "doc_to_text": "{% if x %}y{% endif %}"},
            {**_BASE, "process_docs": object()}, {**_BASE, "output_type": "loglikelihood"},
            {**_BASE, "doc_to_target": "{{label + 1}}"}, {"doc_to_text": "{{q}}"}]


def test_yaml_conversion_equals_jax():
    doc = {"goal": "keep ice", "endings": ["use a cooler", "use an oven"], "label": 0,
           "question": "2+2", "answer": "4", "page": "some document"}
    for cfg in YAML_CONFIGS:
        spec = tcompat.spec_from_lm_eval_yaml(cfg)
        assert spec == jcompat.spec_from_lm_eval_yaml(cfg)
        assert _render(tspec.make_task(spec), doc) == _render(jspec.make_task(spec), doc)
    for cfg in BAD_YAML:
        with pytest.raises(ValueError) as want:
            jcompat.spec_from_lm_eval_yaml(cfg)
        with pytest.raises(ValueError) as got:
            tcompat.spec_from_lm_eval_yaml(cfg)
        assert str(got.value) == str(want.value)


def test_spec_and_wrapped_tasks_evaluate_on_the_model_as_jax():
    config = small_config(vocab_size=260, num_hidden_layers=2)
    jp = init_params(jax.random.PRNGKey(2), config)

    class JLM(jharness.EvalLM):
        max_gen_toks = 16

    class LM(tharness.EvalLM):
        max_gen_toks = 16

    jlm = JLM(jp, config, JByteTokenizer(vocab_size=260))
    tlm = LM(to_port(jp), port_config(config), ByteTokenizer(vocab_size=260))
    docs = {"lambada": [{"text": "aa bb cc dd"}, {"text": "hello world again"}, {"text": "x y"}],
            "t_gen": [{"q": "aa", "answer": ""}, {"q": "bb", "answer": "zz"}],
            "t_roll": [{"page": "hello rolling world"}, {"page": "b" * 300}],
            "w_ll": [{"text": "the sky is blue"}, {"text": "grass is green"}],
            "w_gen": [{"q": "ab", "answer": "xyzzy"}]}
    wrapped = {"w_ll": Fake030LoglikTask, "w_gen": Fake030GenTask}
    results = []
    for harness, spec, compat, lm in ((jharness, jspec, jcompat, jlm),
                                      (tharness, tspec, tcompat, tlm)):
        try:
            for s in EXTRA_SPECS[2:]:
                spec.register_task_spec(s)
            for name, cls in wrapped.items():
                harness.TASK_REGISTRY[name] = compat.wrap_lm_eval_task(cls(docs[name]), name)
            # lambada comes from the shipped spec library on first lookup
            results.append(harness.evaluate_tasks(lm, list(docs), docs_override=docs))
        finally:
            for name in ("lambada", "t_gen", "t_roll", *wrapped):
                harness.TASK_REGISTRY.pop(name, None)
    want, got = results
    assert set(got) == set(docs) | {"mean"}
    for name in docs:
        assert got[name].keys() == want[name].keys()
        for k, v in want[name].items():
            assert got[name][k] == pytest.approx(v, rel=1e-4), (name, k)
    assert got["mean"] == pytest.approx(want["mean"], rel=1e-4)
