"""Training of the LM substrate (the port of ``repro.train``): the
reference's AdamW and schedule, and the train step with chunked
cross-entropy, remat and microbatch accumulation."""
from .optimizer import OptConfig, apply_updates, init_opt_state, schedule
from .step import TrainConfig, init_train_state, make_eval_step, make_loss_fn, make_train_step

__all__ = [
    "OptConfig", "apply_updates", "init_opt_state", "schedule",
    "TrainConfig", "init_train_state", "make_eval_step", "make_loss_fn", "make_train_step",
]
