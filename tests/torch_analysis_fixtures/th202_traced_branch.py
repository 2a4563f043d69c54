"""TH202: Python branching on tensor values in steady-state code — a
function a ``StepGraph`` captures (decided once, at capture) or a
``@tags.hot_loop`` body. Shape and None checks stay legal."""
from repro_torch import graphs
from repro_torch.analysis import tags


def relu_bad(x):
    if x.sum() > 0:  # TH202: tensor-value branch
        return x.relu()
    return x * 0


def pad_ok(x):
    if x.ndim == 1:  # quiet: shape metadata is fixed at capture
        return x[None]
    return x


@tags.hot_loop
def guard(x, mask):
    out = x if mask is None else x * mask  # quiet: None check
    return out


def capture(x, device):
    a = graphs.StepGraph(lambda: relu_bad(x), device)
    b = graphs.StepGraph(lambda: pad_ok(x), device)
    return a, b
