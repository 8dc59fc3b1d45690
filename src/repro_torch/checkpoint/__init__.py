from repro_torch.checkpoint.io import (CheckpointError, export_to_s3,
                                       load_checkpoint, read_manifest,
                                       save_checkpoint)
from repro_torch.checkpoint.manager import (CheckpointManager,
                                            list_checkpoints)

__all__ = ["save_checkpoint", "load_checkpoint", "read_manifest",
           "export_to_s3", "CheckpointError", "CheckpointManager",
           "list_checkpoints"]
