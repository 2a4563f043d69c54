"""TH201 in a ``@tags.hot_loop`` body: host reads and coercions are
flagged ANYWHERE, no loop statement required. The ``host_boundary`` twin
doing the same fetch is sanctioned."""
from repro_torch.analysis import tags


@tags.hot_loop
def block_step_bad(state):
    k = float(state.remaining.min())    # TH201: host coercion
    n = state.active.sum().item()       # TH201: device->host read
    toks = state.gen_buf.cpu()          # TH201: device->host copy
    return k, n, toks


@tags.host_boundary("once-per-wave retirement fetch, amortized over the "
                    "whole drain")
def retire_wave_ok(state):
    return state.gen_buf.cpu().numpy()  # quiet: sanctioned crossing
