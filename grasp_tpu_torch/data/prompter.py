"""Instruction prompt templating for recovery training (the port's own copy
of grasp_tpu/data/prompter.py; it returns numpy, as that module does).

Equivalent of the reference Prompter (prompter.py:5-52) over the standard
Alpaca-LoRA template (tools/prompt_template/alpaca.json). Templates are
registered in-code; extra templates can be loaded from a JSON file with the
same {prompt_input, prompt_no_input, response_split} schema.
"""

from __future__ import annotations

import json
import os
from typing import Dict, Optional

import numpy as np

_TEMPLATES: Dict[str, Dict[str, str]] = {
    "alpaca": {
        "description": "Template used by Alpaca-LoRA.",
        "prompt_input": (
            "Below is an instruction that describes a task, paired with an input "
            "that provides further context. Write a response that appropriately "
            "completes the request.\n\n### Instruction:\n{instruction}\n\n"
            "### Input:\n{input}\n\n### Response:\n"
        ),
        "prompt_no_input": (
            "Below is an instruction that describes a task. Write a response that "
            "appropriately completes the request.\n\n### Instruction:\n"
            "{instruction}\n\n### Response:\n"
        ),
        "response_split": "### Response:",
    },
}


class Prompter:
    def __init__(self, template_name: str = "alpaca", template_dir: Optional[str] = None,
                 verbose: bool = False):
        self._verbose = verbose
        if template_name in _TEMPLATES:
            self.template = _TEMPLATES[template_name]
        else:
            path = os.path.join(template_dir or "prompt_templates", f"{template_name}.json")
            if not os.path.exists(path):
                raise FileNotFoundError(f"Can't open {path}")
            with open(path) as f:
                self.template = json.load(f)
        if self._verbose:
            print(f"Using prompt template {template_name}: {self.template.get('description', '')}")

    def generate_prompt(self, instruction: str, input: Optional[str] = None,
                        label: Optional[str] = None) -> str:
        if input:
            res = self.template["prompt_input"].format(instruction=instruction, input=input)
        else:
            res = self.template["prompt_no_input"].format(instruction=instruction)
        if label:
            res = f"{res}{label}"
        if self._verbose:
            print(res)
        return res

    def get_response(self, output: str) -> str:
        return output.split(self.template["response_split"])[1].strip()


def tokenize_alpaca_example(
    data_point: Dict[str, str],
    tokenizer,
    prompter: Prompter,
    max_length: int = 256,
    train_on_inputs: bool = True,
    add_eos_token: bool = False,
) -> Dict[str, list]:
    """Reference alpaca_grasp.py:95-136: build + tokenize one instruction example.

    labels == input_ids (HF shifts internally); when train_on_inputs=False the
    user-prompt prefix is masked with -100.
    """

    def _tokenize(prompt: str, add_eos: bool = True) -> Dict[str, list]:
        enc = tokenizer(prompt, truncation=True, max_length=max_length,
                        padding=False, return_tensors=None)
        ids, mask = list(enc["input_ids"]), list(enc["attention_mask"])
        eos = getattr(tokenizer, "eos_token_id", None)
        if eos is not None and (not ids or ids[-1] != eos) and len(ids) < max_length and add_eos:
            ids.append(eos)
            mask.append(1)
        return {"input_ids": ids, "attention_mask": mask, "labels": ids.copy()}

    full = prompter.generate_prompt(
        instruction=data_point["instruction"],
        input=data_point.get("input"),
        label=data_point["output"],
    )
    tokenized = _tokenize(full)
    if not train_on_inputs:
        user = prompter.generate_prompt(
            instruction=data_point["instruction"], input=data_point.get("input")
        )
        user_len = len(_tokenize(user, add_eos=add_eos_token)["input_ids"])
        if add_eos_token:
            user_len -= 1
        tokenized["labels"] = [-100] * user_len + tokenized["labels"][user_len:]
    return tokenized


def collate_padded(examples, pad_token_id: int = 0, pad_to_multiple_of: int = 8):
    """Right-pad a list of variable-length examples into one numpy batch.

    Divergence note: the reference uses left padding via tokenizer config
    (alpaca_grasp.py:92-93) + DataCollatorForSeq2Seq; with -100 label masking
    and explicit attention masks the loss is padding-side invariant, so we use
    the simpler right padding.
    """
    max_len = max(len(e["input_ids"]) for e in examples)
    if pad_to_multiple_of:
        max_len = ((max_len + pad_to_multiple_of - 1) // pad_to_multiple_of) * pad_to_multiple_of
    n = len(examples)
    input_ids = np.full((n, max_len), pad_token_id, dtype=np.int64)
    labels = np.full((n, max_len), -100, dtype=np.int64)
    mask = np.zeros((n, max_len), dtype=np.int64)
    for i, e in enumerate(examples):
        L = len(e["input_ids"])
        input_ids[i, :L] = e["input_ids"]
        labels[i, :L] = e["labels"]
        mask[i, :L] = e["attention_mask"]
    return {"input_ids": input_ids, "labels": labels, "attention_mask": mask}
