"""The benign flow the analyzer must NOT flag: a declared, metered
uplink and a downlink-laundered loss feed to the ZOO estimator (the shape
of ``repro_torch.core.async_engine``'s ``client_zoo_grad``)."""
from repro_torch.analysis import tags
from repro_torch.core import zoo


@tags.wire("up", accounted_by="Transport.account", kind="embedding",
           reason="declared uplink: clean + perturbed embeddings, metered "
                  "by the fixture Transport")
def cascaded_step(adapter, transport, params, batch, u_stack, mu, phi,
                  normals):
    lanes = adapter.client_lanes(params["clients"], batch, u_stack, mu)
    losses = adapter.server_loss(params["server"], lanes, batch)  # declared
    recv = transport.downlink(losses, normals)  # DP noise + ledger
    return zoo.grad_from_losses(u_stack, recv[:, 1:], recv[:, 0], mu,
                                phi)  # laundered
