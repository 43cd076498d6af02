"""Evaluation of the port (counterpart of grasp_tpu.eval): perplexity, the
zero/few-shot harness, generation and LongBench."""

from grasp_tpu_torch.eval.ppl import evaluate_perplexity, windowed_perplexity  # noqa: F401
from grasp_tpu_torch.eval.generate import (  # noqa: F401
    Generator,
    SamplingGenerator,
    filter_logits,
    greedy_generate,
)
from grasp_tpu_torch.eval.harness import EvalLM, evaluate_tasks, TASK_REGISTRY  # noqa: F401
from grasp_tpu_torch.eval.task_spec import (  # noqa: F401
    load_task_specs,
    make_task,
    register_task_spec,
)
from grasp_tpu_torch.eval.longbench import (  # noqa: F401
    FULL_LONGBENCH_DATASETS,
    SMALL_LONGBENCH_DATASETS,
    eval_longbench,
    scorer,
    scorer_e,
)
