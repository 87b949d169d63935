from repro_torch.checkpointing.checkpoint import (  # noqa: F401
    latest_step, restore, save)
