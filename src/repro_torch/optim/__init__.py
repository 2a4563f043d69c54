from repro_torch.optim.optimizers import (Optimizer, adamw, in_place,
                                          placed_like_params, sgd)
from repro_torch.optim.schedule import (constant, cosine, inv_sqrt,
                                        make_schedule, warmup_cosine)

__all__ = ["Optimizer", "adamw", "in_place", "placed_like_params", "sgd",
           "constant", "cosine", "inv_sqrt", "make_schedule",
           "warmup_cosine"]
