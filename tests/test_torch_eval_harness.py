"""The port's zero/few-shot harness against the JAX package on the same
weights: ``EvalLM.loglikelihood`` and ``loglikelihood_rolling`` sums within
rtol/atol 1e-4 with identical ``is_greedy``; ``evaluate_tasks`` sends the
same request stream as JAX's (the lm-eval 0.3.0 traces of
tests/test_harness_fidelity.py, every built-in task, few-shot from a train
split and without one) and, on the model, returns the same result dict.
"""

import jax
import numpy as np
import pytest

from grasp_tpu.data.tokenizer import ByteTokenizer as JByteTokenizer
from grasp_tpu.eval import harness as jharness
from grasp_tpu.models import init_params
from grasp_tpu.models.llama import default_plan
from grasp_tpu_torch.data.tokenizer import ByteTokenizer
from grasp_tpu_torch.eval import harness as tharness
from test_harness_fidelity import ARC_DOCS, ARC_TRAIN, RecordingLM
from test_task_spec import DOCS
from torch_parity import (grasp_compressed, one_torch_thread, port_config,  # noqa: F401
                          small_config, to_port)

TOL = dict(rtol=1e-4, atol=1e-4)

REQUESTS = [("The sky is", " blue"), ("", "an empty context"), ("Question: 2+2?\nAnswer:", " 4"),
            ("ab", "c"), ("x" * 300, " y" * 3), ("héllo wörld", " ünïcode"),
            ("Cats are", " mammals"), ("Fish", " swim fast"), ("one two", " three")]


@pytest.fixture(scope="module")
def models():
    config = small_config(vocab_size=260, max_position_embeddings=256)
    comp, plan = grasp_compressed(config)
    dense = init_params(jax.random.PRNGKey(0), config)
    return config, {"dense": (dense, default_plan(config)), "grasp": (comp, plan)}


def _lms(models, which, **kw):
    config, trees = models
    jp, plan = trees[which]
    return (jharness.EvalLM(jp, config, JByteTokenizer(vocab_size=260), plan=plan, **kw),
            tharness.EvalLM(to_port(jp), port_config(config), ByteTokenizer(vocab_size=260),
                            plan=plan, **kw))


@pytest.mark.parametrize("which", ["dense", "grasp"])
def test_loglikelihood_matches_jax(models, which):
    for kw in (dict(), dict(batch_size=3, max_length=64)):
        jlm, tlm = _lms(models, which, **kw)
        want, got = jlm.loglikelihood(REQUESTS), tlm.loglikelihood(REQUESTS)
        np.testing.assert_allclose([ll for ll, _ in got], [ll for ll, _ in want], **TOL)
        assert [g for _, g in got] == [g for _, g in want]
        assert all(ll < 0 for ll, _ in got)


def test_loglikelihood_rolling_matches_jax(models):
    texts = ["the quick brown fox jumps", "a" * 400 + " and more", "x"]
    for kw in (dict(), dict(max_length=16, batch_size=4)):
        jlm, tlm = _lms(models, "grasp", **kw)
        np.testing.assert_allclose(tlm.loglikelihood_rolling(texts),
                                   jlm.loglikelihood_rolling(texts), **TOL)


def _streams(tasks, **kw):
    """The request streams and results of both harnesses under a recording LM."""
    jlm, tlm = RecordingLM(), RecordingLM()
    want = jharness.evaluate_tasks(jlm, tasks, **kw)
    got = tharness.evaluate_tasks(tlm, tasks, **kw)
    return jlm.requests, tlm.requests, want, got


def test_request_streams_equal_jax():
    arc = {"arc_easy": ARC_DOCS}
    for kw in (dict(docs_override=arc), dict(docs_override=arc, limit=2),
               dict(docs_override={**arc, "arc_easy:train": ARC_TRAIN}, num_fewshot=1),
               dict(docs_override=arc, num_fewshot=2), dict(docs_override=arc, seed=7)):
        want_reqs, got_reqs, want, got = _streams(["arc_easy"], **kw)
        assert got_reqs == want_reqs and len(got_reqs) > 0
        assert got == want
    wino = [{"sentence": f"The item {i} broke because _ was heavy.", "option1": "the item",
             "option2": "the shelf", "answer": str(1 + i % 2)} for i in range(5)]
    for fewshot in (0, 1, 3):
        want_reqs, got_reqs, want, got = _streams(
            ["winogrande"], docs_override={"winogrande": wino}, num_fewshot=fewshot)
        assert got_reqs == want_reqs and got == want


def test_every_builtin_task_formats_as_jax():
    names = sorted(DOCS)
    assert set(names) <= set(jharness.TASK_REGISTRY) and set(names) <= set(tharness.TASK_REGISTRY)
    docs = {n: [DOCS[n], DOCS[n]] for n in names}
    docs.update({f"{n}:train": [DOCS[n]] for n in names})
    for fewshot in (0, 1):
        want_reqs, got_reqs, want, got = _streams(names, docs_override=docs,
                                                  num_fewshot=fewshot)
        assert got_reqs == want_reqs and got == want
        assert {k for k, v in got.items() if k != "mean" and "acc_norm" in v} == {
            n for n in names if jharness.TASK_REGISTRY[n].has_acc_norm}
    with pytest.raises(KeyError):
        tharness.evaluate_tasks(RecordingLM(), ["nope"], docs_override=docs)


def test_acc_norm_by_utf8_bytes_as_jax():
    docs = {"arc_easy": [{"question": "pick",
                          "choices": {"text": ["aaaaaaaaaaaaaaaaaaaaaaaaaaaaaaaaaaaaaaa", "bb"],
                                      "label": ["A", "B"]}, "answerKey": "A"}]}

    class LM:
        def loglikelihood(self, requests):
            return [(-20.0, False), (-6.0, False)]

    got = tharness.evaluate_tasks(LM(), ["arc_easy"], docs_override=docs)
    assert got == jharness.evaluate_tasks(LM(), ["arc_easy"], docs_override=docs)
    assert got["arc_easy"] == {"acc": 0.0, "acc_norm": 1.0} and got["mean"] == 0.0


def _model_docs(seed=0, n=6):
    rng = np.random.default_rng(seed)
    words = ["water", "stone", "light", "tree", "river", "cloud", "salt", "iron"]

    def w():
        return " ".join(rng.choice(words, 3))

    return {
        "boolq": [{"passage": w(), "question": w(), "answer": bool(i % 2)} for i in range(n)],
        "piqa": [{"goal": w(), "sol1": w(), "sol2": w(), "label": i % 2} for i in range(n)],
        "arc_easy": [{"question": w(), "choices": {"text": [w(), w(), w()],
                                                   "label": ["A", "B", "C"]},
                      "answerKey": "ABC"[i % 3]} for i in range(n)],
        "hellaswag": [{"activity_label": "Doing", "ctx_a": w(), "ctx_b": w(),
                       "endings": [w(), w()], "label": i % 2} for i in range(n)],
        "winogrande": [{"sentence": f"The {w()} fell because _ was heavy.",
                        "option1": w(), "option2": w(), "answer": str(1 + i % 2)}
                       for i in range(n)],
    }


def test_evaluate_tasks_on_the_model_equals_jax(models):
    jlm, tlm = _lms(models, "grasp", batch_size=8)
    docs = _model_docs()
    docs["piqa:train"] = _model_docs(1)["piqa"]
    tasks = ["boolq", "piqa", "arc_easy", "hellaswag", "winogrande"]
    for kw in (dict(), dict(num_fewshot=1, limit=4)):
        want = jharness.evaluate_tasks(jlm, tasks, docs_override=docs, **kw)
        got = tharness.evaluate_tasks(tlm, tasks, docs_override=docs, **kw)
        assert got == want and set(got) == set(tasks) | {"mean"}
