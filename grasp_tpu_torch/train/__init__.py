"""Recovery training of the port (counterpart of grasp_tpu.train)."""

from grasp_tpu_torch.train.recover import (  # noqa: F401
    count_trainable,
    latest_checkpoint,
    load_train_meta,
    load_train_state,
    make_accum_train_step,
    make_eval_step,
    make_optimizer,
    make_subtree_accum_train_step,
    make_subtree_train_step,
    make_train_step,
    recovery_train,
    save_train_state,
    stack_micro_batches,
    trainable_mask,
)
