"""Training: optimizer, the train step and its shardings, checkpointing,
the elastic trainer (a copy of ``repro.train``)."""
from repro_torch.train.optim import (TrainConfig, adamw_update,  # noqa: F401
                                     init_opt, lr_at)
from repro_torch.train.step import (abstract_train_state,  # noqa: F401
                                    batch_defs, batch_shardings,
                                    init_train_state, make_train_step,
                                    state_shardings, train_state_defs)
