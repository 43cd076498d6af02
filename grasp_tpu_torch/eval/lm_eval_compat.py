"""lm-eval task ingestion — arbitrary-task parity made mechanical
(counterpart of grasp_tpu/eval/lm_eval_compat.py).

The torch reference forwards ANY lm-eval 0.3.0 task name to the installed
library (the reference's `evaluate_grasp.py:222-229`), so it gets every
library task for free; our native harness ships the published-table tasks as
hand-written classes plus declarative JSON specs (eval/task_spec.py). This
module closes the residual surface two ways, with zero hard dependency on
the library (nothing here imports lm_eval at module scope — everything takes
task OBJECTS or parsed config dicts):

1. ``wrap_lm_eval_task(task, name)`` — adapt a LIVE lm-eval 0.3.0 task
   object into our harness's Task interface, so
   ``evaluate_tasks(..., tasks={name: wrap_lm_eval_task(t, name)})`` scores
   it through the port's scoring and generation paths with 0.3.0 semantics — the same
   capability the reference gets from `simple_evaluate`, on the same
   precondition (the library is installed and can build the task). All four
   0.3.0 request protocols are covered, classified by duck-typing
   ``construct_requests`` on one sample doc (each 0.3.0 Request carries a
   ``request_type`` string — no lm_eval import needed):
     - multiple loglikelihoods / docs with ``choices``+``gold`` -> the MC
       wrapper (request layout, acc/acc_norm, fewshot joining);
     - one ``loglikelihood`` -> single-continuation wrapper (lambada
       protocol: acc = is_greedy fraction, ppl);
     - ``greedy_until`` -> generation wrapper (stops from the request,
       per-doc scoring via the live task's own ``process_results``);
     - ``loglikelihood_rolling`` -> rolling wrapper (whole-document
       word/byte perplexity through EvalLM.loglikelihood_rolling).

2. ``spec_from_lm_eval_yaml(cfg)`` — convert an lm-eval 0.4-style YAML task
   config (the declarative successor format) into our JSON spec
   (eval/task_specs.json shape) for the common template subset:
   ``doc_to_text`` jinja field templates, ``doc_to_choice`` static lists or
   field references, ``doc_to_target`` field/index golds; ``output_type``
   may be ``multiple_choice``, ``generate_until`` (stops from
   ``generation_kwargs.until``, exact_match scoring) or
   ``loglikelihood_rolling`` (text from the ``doc_to_target`` field).
   Non-declarative configs (``!function`` hooks, jinja
   filters/conditionals) raise with a pointer to the hand-spec escape
   hatch.
"""

from __future__ import annotations

import re
from typing import Any, Dict, List, Optional

from grasp_tpu_torch.eval.harness import Task

__all__ = ["wrap_lm_eval_task", "spec_from_lm_eval_yaml"]


class _WrappedLMEvalTask(Task):
    """Our harness Task backed by a live lm-eval 0.3.0 task object."""

    def __init__(self, lm_task: Any, name: str):
        self.name = name
        self._t = lm_task
        # 0.3.0 multiple-choice protocol: processed docs carry the option
        # strings under "choices" and the answer index under "gold";
        # doc_to_text renders the context. Anything else needs the
        # generation/loglikelihood spec path instead.
        for attr in ("doc_to_text",):
            if not callable(getattr(lm_task, attr, None)):
                raise TypeError(
                    f"{name}: not an lm-eval 0.3.0 task object (missing "
                    f"{attr}); pass the constructed task, not its name")
        self.has_acc_norm = True  # 0.3.0 MultipleChoiceTask reports both

    def docs(self, data_root: str = ".") -> List[dict]:
        t = self._t
        if getattr(t, "has_validation_docs", lambda: False)():
            docs = t.validation_docs()
        elif getattr(t, "has_test_docs", lambda: False)():
            docs = t.test_docs()
        else:
            raise ValueError(f"{self.name}: task has no validation/test docs")
        docs = list(docs)
        for d in docs[:1]:
            if "choices" not in d or "gold" not in d:
                raise TypeError(
                    f"{self.name}: docs lack 'choices'/'gold' — only 0.3.0 "
                    "MultipleChoiceTask-protocol tasks can be wrapped; write "
                    "a generation/loglikelihood spec (eval/task_spec.py) "
                    "for free-form tasks")
        return docs

    def train_docs(self, data_root: str = ".") -> Optional[List[dict]]:
        t = self._t
        if getattr(t, "has_training_docs", lambda: False)():
            return list(t.training_docs())
        return None

    def context(self, doc: dict) -> str:
        return self._t.doc_to_text(doc)

    def choices(self, doc: dict) -> List[str]:
        # 0.3.0 MultipleChoiceTask.construct_requests scores " {choice}"
        return [" " + c for c in doc["choices"]]

    def gold(self, doc: dict) -> int:
        return int(doc["gold"])


def _task_docs(lm_task: Any, name: str) -> List[dict]:
    if getattr(lm_task, "has_validation_docs", lambda: False)():
        return list(lm_task.validation_docs())
    if getattr(lm_task, "has_test_docs", lambda: False)():
        return list(lm_task.test_docs())
    raise ValueError(f"{name}: task has no validation/test docs")


class _WrappedBase(Task):
    """Shared doc plumbing for the non-MC 0.3.0 wrappers."""

    def __init__(self, lm_task: Any, name: str):
        self.name = name
        self._t = lm_task

    def docs(self, data_root: str = ".") -> List[dict]:
        return _task_docs(self._t, self.name)

    def train_docs(self, data_root: str = ".") -> Optional[List[dict]]:
        t = self._t
        if getattr(t, "has_training_docs", lambda: False)():
            return list(t.training_docs())
        return None

    def context(self, doc: dict) -> str:
        return self._t.doc_to_text(doc)

    def _requests(self, doc: dict):
        reqs = self._t.construct_requests(doc, self._t.doc_to_text(doc))
        return list(reqs) if isinstance(reqs, (list, tuple)) else [reqs]

    def gold(self, doc: dict) -> int:
        return 0


class _WrappedLoglikTask(_WrappedBase):
    """0.3.0 single-continuation protocol (lambada family): one
    loglikelihood request per doc; the harness reports acc (is_greedy
    fraction) + ppl via its ``loglik`` branch."""

    has_acc_norm = False
    loglik = True

    def target(self, doc: dict) -> str:
        return str(self._requests(doc)[0].args[1])

    def choices(self, doc: dict) -> List[str]:  # few-shot gold labels
        return [self.target(doc)]


class _WrappedGenerationTask(_WrappedBase):
    """0.3.0 ``greedy_until`` protocol: generate, then score each doc with
    the live task's OWN ``process_results`` (EM/F1/accuracy — whatever the
    task defines; fractional values average via the harness's float
    aggregation)."""

    has_acc_norm = False
    generation = True

    def __init__(self, lm_task: Any, name: str, stops):
        super().__init__(lm_task, name)
        self.stops = tuple(stops or ())

    def target(self, doc: dict) -> str:
        return str(self._t.doc_to_target(doc))

    def choices(self, doc: dict) -> List[str]:  # few-shot gold labels
        return [self.target(doc)]

    def score(self, generated: str, doc: dict) -> float:
        res = self._t.process_results(doc, [generated])
        if not isinstance(res, dict) or not res:
            raise TypeError(
                f"{self.name}: process_results returned {type(res).__name__},"
                " expected a 0.3.0 metric dict")
        for key in ("em", "exact_match", "acc", "accuracy", "f1"):
            if key in res:
                return float(res[key])
        return float(next(iter(res.values())))


class _WrappedRollingTask(_WrappedBase):
    """0.3.0 ``loglikelihood_rolling`` protocol (wikitext family):
    whole-document scoring; word/byte counts delegate to the task when it
    defines them (wikitext's custom count_words)."""

    has_acc_norm = False
    rolling = True

    def text(self, doc: dict) -> str:
        return str(self._requests(doc)[0].args[0])

    def count_words(self, text: str) -> int:
        fn = getattr(self._t, "count_words", None)
        if callable(fn):
            return int(fn(text))
        return len(re.split(r"\s+", text))

    def count_bytes(self, text: str) -> int:
        fn = getattr(self._t, "count_bytes", None)
        if callable(fn):
            return int(fn(text))
        return len(text.encode("utf-8"))

    def choices(self, doc: dict) -> List[str]:
        return []


def wrap_lm_eval_task(lm_task: Any, name: str) -> Task:
    """Adapt a constructed lm-eval 0.3.0 task object to our Task interface.

    Protocol classification is structural: ``construct_requests`` is called
    on one sample doc and the returned Request objects' ``request_type``
    strings decide the wrapper (greedy_until -> generation, single
    loglikelihood -> lambada-style, loglikelihood_rolling -> wikitext-style,
    several loglikelihoods or docs carrying ``choices``+``gold`` -> the
    multiple-choice wrapper). Tasks without ``construct_requests`` fall back
    to the MC protocol (processed docs with ``choices``/``gold``)."""
    for attr in ("doc_to_text",):
        if not callable(getattr(lm_task, attr, None)):
            raise TypeError(
                f"{name}: not an lm-eval 0.3.0 task object (missing "
                f"{attr}); pass the constructed task, not its name")
    if callable(getattr(lm_task, "construct_requests", None)):
        try:
            sample = next(iter(_task_docs(lm_task, name)))
        except StopIteration:
            sample = None
        if sample is not None:
            reqs = lm_task.construct_requests(
                sample, lm_task.doc_to_text(sample))
            reqs = list(reqs) if isinstance(reqs, (list, tuple)) else [reqs]
            rtypes = [getattr(r, "request_type", None) for r in reqs]
            if rtypes == ["greedy_until"]:
                stops = reqs[0].args[1] if len(reqs[0].args) > 1 else ()
                return _WrappedGenerationTask(lm_task, name, stops)
            if rtypes == ["loglikelihood_rolling"]:
                return _WrappedRollingTask(lm_task, name)
            if rtypes == ["loglikelihood"] and not (
                    "choices" in sample and "gold" in sample):
                return _WrappedLoglikTask(lm_task, name)
            # several loglikelihood requests (or choices/gold docs):
            # multiple-choice protocol below
    return _WrappedLMEvalTask(lm_task, name)


# ---------------------------------------------------------------------------
# 0.4-style YAML config -> our JSON spec
# ---------------------------------------------------------------------------

_JINJA_FIELD = re.compile(r"\{\{\s*([A-Za-z_][\w.]*)\s*\}\}")
_JINJA_ANY = re.compile(r"\{[{%#]")


def _jinja_to_format(template: str, what: str) -> str:
    """`{{field}}` jinja -> str.format; reject code-bearing templates."""
    if not isinstance(template, str):
        raise ValueError(f"{what}: expected a template string, got "
                         f"{type(template).__name__} — non-declarative "
                         "configs need a hand-written spec (eval/task_spec.py)")
    stripped = _JINJA_FIELD.sub("", template)
    if "{" in stripped or "}" in stripped:
        raise ValueError(
            f"{what}: jinja beyond plain {{{{field}}}} holes ({template!r}) "
            "— filters/conditionals/function hooks need a hand-written spec "
            "(eval/task_spec.py)")
    return _JINJA_FIELD.sub(lambda m: "{" + m.group(1) + "}", template)


def spec_from_lm_eval_yaml(cfg: Dict[str, Any]) -> Dict[str, Any]:
    """Convert a parsed lm-eval 0.4-style YAML task config into our spec.

    Supported subset (covers the library's plain multiple-choice configs):
      task (name), doc_to_text ({{field}} template), doc_to_choice (static
      string list | "{{field}}" list-field reference), doc_to_target (int |
      "{{field}}" int-field reference), test_split / validation_split.
    ``output_type`` must be multiple_choice (or absent). Everything else
    (``!function`` values arrive as non-strings from YAML loaders, jinja
    filters, process_docs hooks) raises ValueError.
    """
    name = cfg.get("task")
    if not name:
        raise ValueError("config has no 'task' name")
    out_type = cfg.get("output_type", "multiple_choice")
    if out_type not in ("multiple_choice", "generate_until",
                        "loglikelihood_rolling"):
        raise ValueError(
            f"{name}: output_type {out_type!r} is not convertible — write a "
            "generation/loglikelihood spec by hand (eval/task_spec.py)")
    if cfg.get("process_docs") is not None:
        raise ValueError(f"{name}: process_docs hooks are code, not data — "
                         "write a hand spec (eval/task_spec.py)")

    splits = [s for s in (cfg.get("validation_split"), cfg.get("test_split"))
              if s]

    if out_type == "loglikelihood_rolling":
        # wikitext-style configs: doc_to_text is empty, doc_to_target is the
        # document field ("{{page}}")
        target = cfg.get("doc_to_target")
        m = _JINJA_FIELD.fullmatch(str(target).strip()) if isinstance(
            target, str) else None
        if not m:
            raise ValueError(
                f"{name}: loglikelihood_rolling needs doc_to_target to be a "
                "plain {{field}} reference to the document text")
        spec = {"name": name, "type": "loglikelihood_rolling",
                "text": {"field": m.group(1)}}
        if splits:
            spec["split_candidates"] = splits
        return spec

    if out_type == "generate_until":
        target = cfg.get("doc_to_target")
        m = _JINJA_FIELD.fullmatch(str(target).strip()) if isinstance(
            target, str) else None
        if not m:
            raise ValueError(
                f"{name}: generate_until needs doc_to_target to be a plain "
                "{{field}} reference (function golds need a hand spec, "
                "eval/task_spec.py)")
        stops = (cfg.get("generation_kwargs") or {}).get("until", [])
        if not (isinstance(stops, list)
                and all(isinstance(s, str) for s in stops)):
            raise ValueError(f"{name}: generation_kwargs.until must be a "
                             "list of stop strings")
        spec = {
            "name": name, "type": "generation",
            "context": _jinja_to_format(cfg["doc_to_text"],
                                        f"{name}.doc_to_text"),
            "target": {"field": m.group(1)},
            "stops": stops,
            # 0.4's default generate_until metric is exact_match on the
            # stripped generation — our "exact" rule
            "match": "exact",
        }
        if splits:
            spec["split_candidates"] = splits
        return spec

    spec: Dict[str, Any] = {
        "name": name,
        "type": "multiple_choice",
        "context": _jinja_to_format(cfg["doc_to_text"], f"{name}.doc_to_text"),
    }

    if splits:
        spec["split_candidates"] = splits

    choice = cfg.get("doc_to_choice")
    if isinstance(choice, list):
        if not all(isinstance(c, str) and not _JINJA_ANY.search(c)
                   for c in choice):
            raise ValueError(f"{name}: doc_to_choice list must be static "
                             "strings")
        spec["choices"] = {"static": choice}
    elif isinstance(choice, str):
        m = _JINJA_FIELD.fullmatch(choice.strip())
        if not m:
            raise ValueError(f"{name}: doc_to_choice {choice!r} is not a "
                             "plain field reference")
        spec["choices"] = {"field": m.group(1), "prefix": " "}
    else:
        raise ValueError(f"{name}: doc_to_choice must be a static list or a "
                         "{{field}} reference")

    target = cfg.get("doc_to_target")
    if isinstance(target, int):
        spec["gold"] = {"static": target}
    elif isinstance(target, str):
        m = _JINJA_FIELD.fullmatch(target.strip())
        if not m:
            raise ValueError(f"{name}: doc_to_target {target!r} is not a "
                             "plain field reference")
        spec["gold"] = {"field": m.group(1)}
    else:
        raise ValueError(f"{name}: doc_to_target must be an int index or a "
                         "{{field}} reference")

    # 0.4 semantics: acc_norm reported for multiple_choice
    spec["has_acc_norm"] = True
    return spec
