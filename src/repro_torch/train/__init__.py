"""Training of the port: AdamW, the train step with its gradient-reduction
hook, the synthetic token stream, checkpoints and the fault-tolerant
supervisor."""
from .data import DataConfig, host_batch_slice  # noqa: F401
from .optimizer import (AdamWConfig, AdamWState, adamw_update,  # noqa: F401
                        global_norm, init_adamw, lr_schedule)
from .train_step import (TrainConfig, cast_params,  # noqa: F401
                         init_train_state, loss_and_grad, make_train_step)
from . import checkpoint  # noqa: F401
from .fault_tolerance import (FaultInjector, LinkFault,  # noqa: F401
                              StragglerMonitor, TrainSupervisor,
                              elastic_plan)
