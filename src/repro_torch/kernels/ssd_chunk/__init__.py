from repro_torch.kernels.ssd_chunk.ops import ssd_chunk, ssd_chunk_bshp

__all__ = ["ssd_chunk", "ssd_chunk_bshp"]
