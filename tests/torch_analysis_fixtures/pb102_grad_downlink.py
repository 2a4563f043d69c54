"""PB102 three ways, each without a declared "down" wire: an autograd
gradient pushed into a client hook, a ``torch.func`` gradient returned
from client-party code, and a ``.grad`` read after ``.backward()``
returned from a client function."""
import torch

from repro_torch.analysis import tags


def push_exact_grads(adapter, params, batch, loss):
    g = torch.autograd.grad(loss, params)
    adapter.client_forward(g, batch)  # PB102: gradient into a client hook
    return g


@tags.party("client")
def client_receives(params, batch):
    g = torch.func.grad_and_value(_loss)(params)
    return g  # PB102: gradient-typed return from client-party code


def client_backprops(c, loss):
    loss.backward()
    return c.grad  # PB102: .grad after .backward(), returned client-ward


def _loss(params):
    return 0.0
