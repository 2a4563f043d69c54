"""LEAKY (graph fixture): DP noise applied AFTER the ZOO estimator
consumed the losses — the (1+q) raw loss scalars cross the wire
unnoised, and the "noise" only perturbs a value that never leaves the
server's blast radius. With a DP channel configured, the downlink
crossing must carry ``dp`` taint (noise BEFORE the wire, as
``Transport.downlink`` does); here it carries raw ``server`` taint, so
the certifier must report **IF303 and nothing else**. The crossing is
correctly shaped ((1+q,) scalars), so IF302 stays quiet — only the
noising ORDER is wrong.
"""
import torch

from repro_torch.analysis import marks

EXPECT = "IF303"


def build():
    mu = 1e-3

    def fn(server_w, u, x, y):
        def loss_at(w):
            return torch.mean((x @ w - y) ** 2)

        # 1 clean + 2 perturbed server losses: the ZOO lane stack
        losses = torch.stack([loss_at(server_w),
                              loss_at(server_w + mu * u),
                              loss_at(server_w - mu * u)])
        # WRONG ORDER: raw losses hit the wire...
        sent = marks.wire_boundary(losses, kind="loss", direction="down")
        est = (sent[1] - sent[0]) / mu      # two-point estimate, client side
        # ...and the noise lands after the estimator already consumed them
        return marks.dp_noise(est * torch.mean(u))

    args = (torch.zeros((3,)), torch.ones((3,)), torch.zeros((8, 3)),
            torch.zeros((8,)))
    return dict(fn=fn, args=args,
                is_server=lambda p: p.startswith("[0]"),
                dp_configured=True, down_limits={"loss": 3})
