"""Checkpointing to .npz in ``repro``'s flat key-path format, numpy only."""
from repro_torch.checkpoint.io import (json_leaf, json_unleaf, latest_step,
                                       load_checkpoint, load_checkpoint_tree,
                                       save_checkpoint)

__all__ = ["save_checkpoint", "load_checkpoint", "load_checkpoint_tree",
           "json_leaf", "json_unleaf", "latest_step"]
