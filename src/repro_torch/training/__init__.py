"""Training: the per-member train step (loss -> grads -> clip -> schedule
-> AdamW) and the fused committee trainer (all K members in one step
program; one captured CUDA graph per trainer on the card)."""
from repro_torch.optim.memory_policy import MemoryPolicy  # noqa: F401
from repro_torch.training.committee_trainer import (  # noqa: F401
    CommitteeTrainer, default_train_config, state_dict_from_reference,
)
from repro_torch.training.train_step import (  # noqa: F401
    CapturedTrainStep, TrainState, make_eval_step, make_train_state,
    make_train_step, train_state_from_reference, train_state_to_reference,
)
