"""Annotation registry of the port (``tags``): the party/wire decorators
stay on the ported functions so a boundary pass can read them."""
from repro_torch.analysis import tags

__all__ = ["tags"]
