from repro_torch.data.pipeline import BatchIterator
from repro_torch.data.synthetic import (
    lm_token_batches,
    make_classification,
    vertical_partition,
)

__all__ = ["lm_token_batches", "make_classification", "vertical_partition",
           "BatchIterator"]
