"""TH204: leftover debug instrumentation."""
import pdb

from repro_torch import graphs


def step(h, x):
    print("capturing", h)  # TH204: prints at capture, never on replay
    h.add_(x)


def stale_breakpoint(x):
    breakpoint()  # TH204
    return x


def stale_pdb(x):
    pdb.set_trace()  # TH204
    return x


def capture(h, x, device):
    return graphs.StepGraph(lambda: step(h, x), device)
