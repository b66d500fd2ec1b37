from repro_torch.checkpoint.checkpoint import (save, restore,  # noqa: F401
                                               save_state, restore_state,
                                               tree_equal)
from repro_torch.checkpoint.federation import (  # noqa: F401
    CheckpointConfig, Checkpointer, latest_checkpoint, list_checkpoints)
