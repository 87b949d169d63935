from repro_torch.optim.adam import (AdamState, FlatAdamState,  # noqa: F401
                                    Optimizer, adam, flat_adam, global_norm,
                                    sgd)
from repro_torch.optim import schedules  # noqa: F401
