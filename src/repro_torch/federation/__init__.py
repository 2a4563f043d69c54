"""One federation API for the port: party-scoped sessions over models,
transports over wires.

    from repro_torch.federation import Federation
    fed = Federation.build(model_cfg, vfl_cfg, engine_cfg)   # on the card
    result = fed.run(params, x_parts, y)      # async protocol (staleness)
    # the client block sharded over D ranks of a torch.distributed group
    # (one process a shard: NCCL on the card, gloo on the CPU; each rank
    # builds the same session and calls run with the same arguments)
    fed = Federation.build(model_cfg, vfl_cfg,
                           EngineConfig(mesh_shards=D), device=dev)
    result = fed.run_population(params, x_parts, y,   # over the wire plane
                                fault_plan=FaultPlan(drop=0.2))
    step = fed.sync_step(opt)                 # the sync LM training step
    fed.save(path, params, step=k, opt_state=opt_state)
    fed, params, state = Federation.restore(path)
    srv = fed.serve(params, max_batch=8)      # continuous batching
    srv.submit(prompt, gen_len); results = srv.run()
"""
from repro_torch.core.privacy import GaussianLossChannel
from repro_torch.federation.parties import (ClientParty, Parties,
                                            ServerParty)
from repro_torch.federation.scheduler import (QueueFull, RequestResult,
                                              SchedulerState, ServeRequest,
                                              ServeScheduler)
from repro_torch.federation.serving import ServeResult
from repro_torch.federation.session import Federation, SessionState
from repro_torch.federation.transport import Transport

__all__ = ["ClientParty", "Federation", "GaussianLossChannel", "Parties",
           "QueueFull", "RequestResult", "SchedulerState", "ServeRequest",
           "ServeResult", "ServeScheduler", "ServerParty", "SessionState",
           "Transport"]
