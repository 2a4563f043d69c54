"""PyTorch/CUDA port of the cascaded hybrid VFL system (for an NVIDIA H100)."""
