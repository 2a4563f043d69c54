from repro_torch.kernels.rmsnorm.ops import rmsnorm

__all__ = ["rmsnorm"]
