"""TH203: literal-dtype casts in the values a captured step writes into
its carried buffers. Casting a temporary and anchoring to the buffer's
``.dtype`` are both fine."""
import torch

from repro_torch import graphs


def step_bad(h_st, x):
    h_st.copy_((h_st + x).to(torch.float32))  # TH203: literal dtype
    h_st[0] = x[0].bfloat16()                 # TH203: literal cast


def step_ok(h_st, x):
    acc = x.to(torch.float32)                 # quiet: a temporary
    h_st.copy_((h_st + acc).to(h_st.dtype))   # quiet: anchored


def capture(h, x, device):
    return (graphs.StepGraph(lambda: step_bad(h, x), device),
            graphs.StepGraph(lambda: step_ok(h, x), device))
