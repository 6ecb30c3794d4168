from floodplanet_code_tpu_torch.train.fit import (
    fit_model,
    make_augment_step,
    make_eval_step,
    make_loss_fn,
    make_train_step,
    resolve_ignore_index,
)
from floodplanet_code_tpu_torch.train.state import (
    TrainState,
    build_optimizer,
    create_train_state,
    ema_decay_at,
    init_weights,
    make_schedule,
)

__all__ = [
    "fit_model",
    "make_augment_step",
    "make_eval_step",
    "make_loss_fn",
    "make_train_step",
    "resolve_ignore_index",
    "TrainState",
    "build_optimizer",
    "create_train_state",
    "ema_decay_at",
    "init_weights",
    "make_schedule",
]
