"""The recovery data path of the port (``grasp_tpu_torch/data/prompter.py``,
``train.recover.stack_micro_batches``) and its loss sum
(``models.llama.hf_causal_lm_loss_sum``) against the JAX package on the same
seed-made Alpaca rows: prompts, tokenized examples and batches equal, the
loss sum within 1e-6 relative.
"""

import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from grasp_tpu.data import prompter as jprompter
from grasp_tpu.data.tokenizer import ByteTokenizer as JByteTokenizer
from grasp_tpu.models import llama as jl
from grasp_tpu.train import recover as jrecover
from grasp_tpu_torch.data import prompter as tprompter
from grasp_tpu_torch.data.tokenizer import ByteTokenizer
from grasp_tpu_torch.models import llama as tl
from grasp_tpu_torch.train import recover as trecover
from torch_parity import alpaca_rows, one_torch_thread  # noqa: F401  (autouse)

# short and long outputs: at max_length 320 some examples are cut, none before
# its response
ROWS = alpaca_rows(0, 24, output_words=(1, 30))
MAX_LENGTH = 320


def test_prompter_prompts_equal(tmp_path):
    ours, theirs = tprompter.Prompter("alpaca"), jprompter.Prompter("alpaca")
    for row in ROWS[:6]:
        for label in (None, row["output"]):
            got = ours.generate_prompt(row["instruction"], row["input"], label)
            assert got == theirs.generate_prompt(row["instruction"], row["input"], label)
        full = ours.generate_prompt(row["instruction"], row["input"], row["output"])
        assert ours.get_response(full) == theirs.get_response(full) == row["output"]
    template = {"description": "short", "prompt_input": "I: {instruction} / {input} ->",
                "prompt_no_input": "I: {instruction} ->", "response_split": "->"}
    (tmp_path / "short.json").write_text(json.dumps(template))
    ours = tprompter.Prompter("short", template_dir=str(tmp_path))
    theirs = jprompter.Prompter("short", template_dir=str(tmp_path))
    for row in ROWS[:3]:
        args = (row["instruction"], row["input"], row["output"])
        assert ours.generate_prompt(*args) == theirs.generate_prompt(*args)
    for module in (tprompter, jprompter):
        with pytest.raises(FileNotFoundError):
            module.Prompter("absent", template_dir=str(tmp_path))


@pytest.mark.parametrize("train_on_inputs, add_eos", [(True, False), (False, False),
                                                      (False, True)])
def test_tokenize_alpaca_example_matches_jax(train_on_inputs, add_eos):
    """Labels equal to the ids, or the user prompt masked with -100 (with the
    reference's off-by-one when ``add_eos_token``), on cut and uncut rows."""
    kw = dict(max_length=MAX_LENGTH, train_on_inputs=train_on_inputs, add_eos_token=add_eos)
    ours, theirs = tprompter.Prompter("alpaca"), jprompter.Prompter("alpaca")
    lengths = set()
    for row in ROWS:
        got = tprompter.tokenize_alpaca_example(row, ByteTokenizer(), ours, **kw)
        want = jprompter.tokenize_alpaca_example(row, JByteTokenizer(), theirs, **kw)
        assert got == want
        lengths.add(len(got["input_ids"]))
        if not train_on_inputs:
            assert got["labels"][0] == -100 and got["labels"][-1] != -100
    assert MAX_LENGTH in lengths and min(lengths) < MAX_LENGTH


def test_collate_padded_and_stack_micro_batches_match_jax():
    prompter = tprompter.Prompter("alpaca")
    examples = [tprompter.tokenize_alpaca_example(r, ByteTokenizer(), prompter,
                                                  max_length=MAX_LENGTH) for r in ROWS]
    batches = []
    for multiple in (8, 0):
        for s in range(0, len(examples), 2):
            got = tprompter.collate_padded(examples[s:s + 2], pad_token_id=0,
                                           pad_to_multiple_of=multiple)
            want = jprompter.collate_padded(examples[s:s + 2], pad_token_id=0,
                                            pad_to_multiple_of=multiple)
            assert got.keys() == want.keys()
            for k in got:
                assert got[k].dtype == want[k].dtype == np.int64
                np.testing.assert_array_equal(got[k], want[k])
            batches.append(got)
    assert len({b["input_ids"].shape[1] for b in batches}) > 2
    # micro-batches of unequal lengths, one without a mask, padded to the longest
    groups = [batches[:3], batches[3:6] + [{"input_ids": batches[6]["input_ids"],
                                            "labels": batches[6]["labels"]}], batches[8:9]]
    for group in groups:
        got = trecover.stack_micro_batches(group, pad_token_id=3)
        want = jrecover.stack_micro_batches(group, pad_token_id=3)
        for k in ("input_ids", "labels", "attention_mask"):
            np.testing.assert_array_equal(got[k], want[k])
    no_mask = [{"input_ids": b["input_ids"], "labels": b["labels"]} for b in batches[:2]]
    assert trecover.stack_micro_batches(no_mask)["attention_mask"] is None


def test_hf_causal_lm_loss_sum_matches_jax():
    rng = np.random.default_rng(4)
    logits = (rng.standard_normal((3, 40, 260)) * 3).astype(np.float32)
    labels = rng.integers(0, 260, (3, 40))
    labels[:, :7] = -100
    labels[1, 20:] = -100
    labels[2] = -100  # a row without a label
    got = tl.hf_causal_lm_loss_sum(torch.from_numpy(logits), torch.from_numpy(labels))
    want = jl.hf_causal_lm_loss_sum(jnp.asarray(logits), jnp.asarray(labels))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.item(), float(want), rtol=1e-6)
    mean = tl.hf_causal_lm_loss(torch.from_numpy(logits), torch.from_numpy(labels))
    np.testing.assert_allclose(mean.item(), float(jl.hf_causal_lm_loss(
        jnp.asarray(logits), jnp.asarray(labels))), rtol=1e-6)
    # bf16 logits: the sum is taken in fp32 all the same
    half = torch.from_numpy(logits).bfloat16()
    assert tl.hf_causal_lm_loss_sum(half, torch.from_numpy(labels)).dtype == torch.float32
