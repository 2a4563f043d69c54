"""PB105: server-evaluated losses fed straight to the client's ZOO
estimator — Transport.downlink (DP noise + ledger) bypassed."""
from repro_torch.core import zoo


def leaky_zoo_update(server_loss, u_stack, mu, phi):
    losses = server_loss(u_stack)
    return zoo.grad_from_losses(u_stack, losses[:, 1:], losses[:, 0],
                                mu, phi)  # PB105
