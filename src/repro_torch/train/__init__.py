"""Training: optimizer, the train step, checkpointing, the elastic trainer
(a copy of ``repro.train``; the sharding names wait for ROADMAP A9.3)."""
from repro_torch.train.optim import (TrainConfig, adamw_update,  # noqa: F401
                                     init_opt, lr_at)
from repro_torch.train.step import (batch_defs,  # noqa: F401
                                    init_train_state, make_train_step,
                                    train_state_defs)
