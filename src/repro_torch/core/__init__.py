"""The paper's contribution: cascaded hybrid optimization for async VFL."""
from repro_torch.core.adapters import (ModelAdapter, mlp_adapter,
                                       tabular_adapter)
from repro_torch.core.draws import (DrawSource, RowDraws, StepDraws,
                                    TorchDraws, seed_directions)
from repro_torch.core.partition import merge_params, split_params, tree_dim
from repro_torch.core.zoo import (
    embedding_row_mask,
    grad_from_losses,
    perturb,
    phi_factor,
    sample_direction,
    sample_directions,
    stack_lanes,
    two_point_grad,
    zoo_gradient,
)

__all__ = [
    "DrawSource",
    "ModelAdapter",
    "RowDraws",
    "StepDraws",
    "TorchDraws",
    "embedding_row_mask",
    "grad_from_losses",
    "merge_params",
    "mlp_adapter",
    "perturb",
    "phi_factor",
    "sample_direction",
    "sample_directions",
    "seed_directions",
    "split_params",
    "stack_lanes",
    "tabular_adapter",
    "tree_dim",
    "two_point_grad",
    "zoo_gradient",
]
