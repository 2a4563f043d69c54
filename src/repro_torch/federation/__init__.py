"""One federation API for the port: party-scoped sessions over models,
transports over wires.

    from repro_torch.federation import Federation
    fed = Federation.build(model_cfg, vfl_cfg, engine_cfg)   # on the card
    result = fed.run(params, x_parts, y)      # async protocol (staleness)
"""
from repro_torch.core.privacy import GaussianLossChannel
from repro_torch.federation.session import Federation
from repro_torch.federation.transport import Transport

__all__ = ["Federation", "GaussianLossChannel", "Transport"]
