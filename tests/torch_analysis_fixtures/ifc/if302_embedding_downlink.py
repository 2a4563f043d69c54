"""LEAKY (graph fixture): the server pushes a full activation matrix
down the loss channel — it does pass through the one legal downlink
(``Transport.downlink``, so the crossing is anchored and laundered), but
the crossing is (4, 3) = 12 elements where the protocol allows at most
(1+q) = 3 scalars: the bottleneck is not scalar-shaped, so the certifier
must report **IF302 and nothing else** (no gradient is involved, the
client output is clean after the launder).

AST-clean: the payload flows through the sanctioned downlink call, so
the source-text rules see a declared wire.
"""
import torch

from repro_torch.federation.transport import Transport

EXPECT = "IF302"


def build():
    transport = Transport("cascaded")

    def fn(server_w, x):
        acts = torch.tanh(x @ server_w)      # (batch, embed) server values
        # the real downlink channel, misused: a matrix is not a loss lane
        return transport.downlink(acts)

    args = (torch.zeros((3, 3)), torch.zeros((4, 3)))
    return dict(fn=fn, args=args,
                is_server=lambda p: p.startswith("[0]"),
                dp_configured=False, down_limits={"loss": 3})
