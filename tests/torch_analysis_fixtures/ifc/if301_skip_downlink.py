"""LEAKY (graph fixture): the client update consumes raw server-side
cotangents and never touches ``Transport.downlink`` — the FOO shortcut
the paper's §V forbids. The engine's gradient anchor
(``marks.grad_mark``, exactly what ``_server_update`` wraps its
first-order gradients in) puts ``grad`` taint on the update, and the
taint reaches a client-bound output with no wire boundary on the path:
the certifier must report **IF301 and nothing else**.

This file is deliberately AST-clean — the source-text passes cannot see
the leak (the gradient call is a bare name, the flow crosses no tagged
attribute), which is the whole point of certifying the traced graph
instead.
"""
import torch
from torch.func import grad

from repro_torch.analysis import marks

EXPECT = "IF301"


def build():
    def objective(client_w, server_w, x, y):
        c = x @ client_w
        s = c @ server_w
        return torch.mean((s - y) ** 2)

    def fn(server_w, client_w, x, y):
        # raw cotangents of the joint objective, handed straight to the
        # client optimizer: skips the loss downlink entirely
        g = marks.grad_mark(grad(objective)(client_w, server_w, x, y))
        return client_w - 0.1 * g

    args = (torch.zeros((4, 2)), torch.zeros((3, 4)), torch.zeros((8, 3)),
            torch.zeros((8, 2)))
    return dict(fn=fn, args=args,
                is_server=lambda p: p.startswith("[0]"),
                dp_configured=False, down_limits={"loss": 3})
