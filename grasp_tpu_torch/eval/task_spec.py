"""Declarative lm-eval task definitions — tasks as data, not code
(counterpart of grasp_tpu/eval/task_spec.py).

The reference can pass any lm-eval 0.3.0 task name straight to
``evaluator.simple_evaluate`` (evaluate_grasp.py:222-229). Our native harness
(eval/harness.py) ships hand-written classes for the reference's 8 default
tasks; this module closes the surface gap: new 0.3.0-style tasks are defined
by a JSON/dict *spec* (doc -> context/choices/gold templates) and registered
at runtime — no code changes. The 8 built-ins are re-expressed in
``task_specs.json`` (the port's own copy of the JAX package's file) and
pinned byte-identical to the hand classes in tests/test_task_spec.py.

Spec shape (all strings are Python str.format templates over the doc; dotted
keys reach into nested dicts):

    {
      "name": "piqa",
      "type": "multiple_choice",            # | "generation" | "partial"
      "split_candidates": ["validation", "test"],
      "has_acc_norm": true,
      "context": "Question: {goal}\\nAnswer:",
      "choices": {"static": [" no", " yes"]}            # fixed strings
               | {"field": "endings", "prefix": " ",    # list field
                  "preprocess": "hellaswag"}            # named fn (registry)
               | {"field": "choices.text", "prefix": " "},
      "gold": {"field": "label"}                        # int(doc[field])
            | {"field": "answer", "cast": "bool"}       # int(bool(...))
            | {"field": "answer", "offset": -1}         # int(...) + offset
            | {"field": "answerKey",
               "label_index": "choices.label"}          # labels.index(key)
            | {"field": "correct",
               "lookup": ["a", "b", "c", "d", "e"]}     # values.index(key)
            | {"static": 1},                            # fixed index
                                                        # (0.4 int doc_to_target)
    }

``type: "partial"`` is lm-eval 0.3.0's winogrande partial-evaluation scheme:
the option fills the blank of ``sentence_field`` and the scored continuation
is the suffix after the blank; extra keys: ``sentence_field``, ``options``
(list of doc fields).

``type: "generation"`` scores greedy_until generations:

    {
      "name": "my_gen_task", "type": "generation",
      "context": "Q: {question}\\nA:",
      "target": {"field": "answer"},           # gold string (same resolver)
      "stops": ["\\n"],                        # until-strings for greedy_until
      "match": "exact"                         # | "contains"
    }

The metric is exact_match (strip-compared) or containment, aggregated as
"acc" so the harness's mean aggregation applies unchanged.

``type: "loglikelihood"`` is lm-eval 0.3.0's single-continuation scheme
(lambada family): one loglikelihood request of ``target`` after ``context``
per doc; acc = fraction where the continuation was the token-wise argmax
(0.3.0's ``is_greedy``), ppl = exp(-mean ll) (0.3.0's ``perplexity``
aggregation):

    {
      "name": "lambada", "type": "loglikelihood",
      "context": "{text}",
      "context_preprocess": {"text": "drop_last_word"},
      "target": {"field": "text", "preprocess": "last_word", "prefix": " "}
    }

``type: "loglikelihood_rolling"`` is 0.3.0's whole-document scheme
(wikitext): the full ``text`` field is scored in rolling windows
(EvalLM.loglikelihood_rolling) and aggregated as word/byte perplexity and
bits_per_byte:

    {
      "name": "wikitext_rolling", "type": "loglikelihood_rolling",
      "text": {"field": "page"}
    }
"""

from __future__ import annotations

import json
import re
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple


# -- named preprocess functions (spec-referenced by name) --------------------

def _hellaswag_preprocess(text: str) -> str:
    text = text.strip().replace(" [title]", ". ")
    text = re.sub(r"\[.*?\]", "", text)
    return text.replace("  ", " ")


def _mathqa_options(options: str) -> List[str]:
    return [
        c[4:].rstrip(" ,")
        for c in re.findall(r"[abcd] \) .*?, |e \) .*?$", options)
    ]


def _drop_last_word(text: str) -> str:
    """lambada doc_to_text: everything before the final word."""
    return text.rsplit(" ", 1)[0]


def _last_word(text: str) -> str:
    """lambada doc_to_target body: the final word (caller adds the " ")."""
    return text.rsplit(" ", 1)[1] if " " in text else text


PREPROCESS_REGISTRY: Dict[str, Callable] = {
    "hellaswag": _hellaswag_preprocess,
    "mathqa_options": _mathqa_options,
    "capitalize": str.capitalize,
    "drop_last_word": _drop_last_word,
    "last_word": _last_word,
}


def _resolve(doc: dict, dotted: str):
    """'choices.text' -> doc['choices']['text']."""
    cur: Any = doc
    for part in dotted.split("."):
        cur = cur[part]
    return cur


class _DotDict(dict):
    """format_map view of a doc that evaluates dotted keys and applies the
    spec's per-field preprocess functions."""

    def __init__(self, doc: dict, field_preprocess: Dict[str, List[str]]):
        super().__init__()
        self._doc = doc
        self._pre = field_preprocess

    def __missing__(self, key):
        val = _resolve(self._doc, key)
        for fn_name in self._pre.get(key, []):
            val = PREPROCESS_REGISTRY[fn_name](val)
        return val


def _format(template: str, doc: dict, field_preprocess: Dict[str, List[str]]) -> str:
    return template.format_map(_DotDict(doc, field_preprocess))


def _gold_fn(spec: dict) -> Callable[[dict], int]:
    g = spec["gold"]
    if "static" in g:  # fixed answer index (lm-eval 0.4 int doc_to_target)
        k = int(g["static"])
        return lambda doc: k
    field = g["field"]

    def gold(doc: dict) -> int:
        val = _resolve(doc, field)
        if "label_index" in g:
            return list(_resolve(doc, g["label_index"])).index(val)
        if "lookup" in g:
            return list(g["lookup"]).index(val)
        if g.get("cast") == "bool":
            return int(bool(val))
        return int(val) + int(g.get("offset", 0))

    return gold


def _choices_fn(spec: dict) -> Callable[[dict], List[str]]:
    c = spec["choices"]
    if "static" in c:
        static = list(c["static"])
        return lambda doc: static

    if "fields" in c:  # one choice per scalar doc field (piqa's sol1/sol2)
        fields, prefix = list(c["fields"]), c.get("prefix", "")
        return lambda doc: [prefix + str(_resolve(doc, f)) for f in fields]

    field, prefix = c["field"], c.get("prefix", "")
    pre = [PREPROCESS_REGISTRY[n] for n in _as_list(c.get("preprocess"))]

    def choices(doc: dict) -> List[str]:
        vals = _resolve(doc, field)
        if isinstance(vals, str):  # a preprocess fn may split a string field
            for fn in pre:
                vals = fn(vals)
            if isinstance(vals, str):
                raise ValueError(
                    f"choices field {field!r} is a string; preprocess must "
                    "produce a list"
                )
            return [prefix + v for v in vals]
        out = []
        for v in vals:
            for fn in pre:
                v = fn(v)
            out.append(prefix + v)
        return out

    return choices


def _as_list(x) -> List[str]:
    if x is None:
        return []
    return [x] if isinstance(x, str) else list(x)


def make_task(spec: dict):
    """Compile a spec dict into a Task instance for TASK_REGISTRY."""
    from grasp_tpu_torch.eval.harness import Task

    kind = spec.get("type", "multiple_choice")
    # per-field preprocess (applied to the field value before formatting) and
    # whole-context postprocess (applied to the formatted string) — both by
    # registry name, e.g. hellaswag's bracket-stripping over the full context
    field_pre = {k: _as_list(v) for k, v in spec.get("context_preprocess", {}).items()}
    ctx_post = [PREPROCESS_REGISTRY[n] for n in _as_list(spec.get("context_postprocess"))]

    def render_context(doc: dict) -> str:
        s = _format(spec["context"], doc, field_pre)
        for fn in ctx_post:
            s = fn(s)
        return s

    if kind == "multiple_choice":
        choices_fn = _choices_fn(spec)
        gold_fn = _gold_fn(spec)

        class SpecTask(Task):
            name = spec["name"]
            split_candidates = tuple(spec.get("split_candidates", ("validation", "test")))
            has_acc_norm = bool(spec.get("has_acc_norm", True))

            def context(self, doc):
                return render_context(doc)

            def choices(self, doc):
                return choices_fn(doc)

            def gold(self, doc):
                return gold_fn(doc)

        return SpecTask()

    if kind == "partial":
        gold_fn = _gold_fn(spec)
        sent_field = spec["sentence_field"]
        option_fields = list(spec["options"])

        class PartialSpecTask(Task):
            name = spec["name"]
            split_candidates = tuple(spec.get("split_candidates", ("validation", "test")))
            has_acc_norm = bool(spec.get("has_acc_norm", False))

            def partial_context(self, doc, option: str) -> str:
                sentence = _resolve(doc, sent_field)
                idx = sentence.index("_")
                return sentence[:idx] + option

            def partial_target(self, doc) -> str:
                sentence = _resolve(doc, sent_field)
                idx = sentence.index("_")
                return " " + sentence[idx + 1 :].strip()

            def context(self, doc):
                return self.partial_context(doc, self.choices(doc)[self.gold(doc)])

            def choices(self, doc):
                return [_resolve(doc, f) for f in option_fields]

            def gold(self, doc):
                return gold_fn(doc)

            def fewshot_context(self, doc, shots):
                parts = [
                    self.partial_context(s, self.choices(s)[self.gold(s)])
                    + self.partial_target(s)
                    for s in shots
                ]
                parts.append(self.context(doc))
                return "\n\n".join(parts)

            def requests(self, ctx: str, doc: dict) -> List[Tuple[str, str]]:
                target = self.partial_target(doc)
                segs = ctx.split("\n\n")[:-1]
                out = []
                for opt in self.choices(doc):
                    pc = self.partial_context(doc, opt)
                    out.append(("\n\n".join([*segs, pc]) if segs else pc, target))
                return out

        return PartialSpecTask()

    if kind == "generation":
        target_spec = spec["target"]

        class GenSpecTask(Task):
            name = spec["name"]
            split_candidates = tuple(spec.get("split_candidates", ("validation", "test")))
            has_acc_norm = False
            generation = True
            stops = tuple(spec.get("stops", ()))
            match = spec.get("match", "exact")

            def context(self, doc):
                return render_context(doc)

            def choices(self, doc):  # gold continuation (few-shot labels)
                return [str(_resolve(doc, target_spec["field"]))]

            def gold(self, doc):
                return 0

            def target(self, doc) -> str:
                return str(_resolve(doc, target_spec["field"]))

            def score(self, generated: str, doc: dict) -> bool:
                want = self.target(doc).strip()
                got = generated.strip()
                if self.match == "contains":
                    return want in got
                return got == want

        return GenSpecTask()

    if kind == "loglikelihood":
        target_spec = spec["target"]
        t_pre = [PREPROCESS_REGISTRY[n] for n in _as_list(target_spec.get("preprocess"))]
        t_prefix = target_spec.get("prefix", "")

        class LoglikSpecTask(Task):
            name = spec["name"]
            split_candidates = tuple(spec.get("split_candidates", ("validation", "test")))
            has_acc_norm = False
            loglik = True  # single-continuation scoring (lambada family)

            def context(self, doc):
                return render_context(doc)

            def target(self, doc) -> str:
                val = str(_resolve(doc, target_spec["field"]))
                for fn in t_pre:
                    val = fn(val)
                return t_prefix + val

            def choices(self, doc):  # gold continuation (few-shot labels)
                return [self.target(doc)]

            def gold(self, doc):
                return 0

        return LoglikSpecTask()

    if kind == "loglikelihood_rolling":
        text_spec = spec["text"]
        x_pre = [PREPROCESS_REGISTRY[n] for n in _as_list(text_spec.get("preprocess"))]

        class RollingSpecTask(Task):
            name = spec["name"]
            split_candidates = tuple(spec.get("split_candidates", ("validation", "test")))
            has_acc_norm = False
            rolling = True  # whole-document scoring (wikitext family)

            def context(self, doc):  # rolling requests use empty context
                return ""

            def text(self, doc) -> str:
                val = str(_resolve(doc, text_spec["field"]))
                for fn in x_pre:
                    val = fn(val)
                return val

            def count_words(self, text: str) -> int:
                # 0.3.0 wikitext counts whitespace-split words
                return len(re.split(r"\s+", text))

            def count_bytes(self, text: str) -> int:
                return len(text.encode("utf-8"))

            def choices(self, doc):  # unused (no MC protocol)
                return []

            def gold(self, doc):
                return 0

        return RollingSpecTask()

    raise ValueError(f"unknown task spec type {kind!r}")


def register_task_spec(spec: dict) -> None:
    """Register a spec-built task into the harness registry."""
    from grasp_tpu_torch.eval.harness import TASK_REGISTRY

    task = make_task(spec)
    TASK_REGISTRY[task.name] = task


def load_task_specs(path: str) -> List[str]:
    """Load one spec or a list of specs from a JSON file; returns the names."""
    with open(path) as f:
        specs = json.load(f)
    if isinstance(specs, dict):
        specs = [specs]
    for spec in specs:
        register_task_spec(spec)
    return [s["name"] for s in specs]
