"""Configs of the port: the paper's tabular MLP and the VFL protocol."""
from repro_torch.configs import paper_mlp
from repro_torch.configs.base import VFLConfig

PAPER_MLP = paper_mlp.CONFIG

__all__ = ["PAPER_MLP", "VFLConfig"]
