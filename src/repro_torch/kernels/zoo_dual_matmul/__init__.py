from repro_torch.kernels.zoo_dual_matmul.ops import (
    zoo_dual_matmul, zoo_dual_matmul_stacked)

__all__ = ["zoo_dual_matmul", "zoo_dual_matmul_stacked"]
