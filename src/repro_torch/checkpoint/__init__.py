from repro_torch.checkpoint.io import (load_checkpoint, load_tree,
                                       save_checkpoint)

__all__ = ["load_checkpoint", "load_tree", "save_checkpoint"]
