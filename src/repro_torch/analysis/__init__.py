"""Static and runtime analysis plane of the port.

- ``analysis.tags`` — annotation registry (party / wire / accounting /
  hot_loop / host_boundary decorators) the static passes read off the AST.
- ``analysis.boundary`` — party-boundary leak rules (PB1xx).
- ``analysis.jitlint`` — trace-hygiene rules (TH2xx) for CUDA-graph
  captured steps and the serve plane's hot loops.
- ``analysis.runtime`` — the host-read and recompile sentinels and the
  ``strict()`` context manager (imports torch; everything else is pure
  AST).
- ``python -m repro_torch.analysis --strict`` — the gate over the port's
  own source.
"""

from repro_torch.analysis import tags
from repro_torch.analysis.cli import analyze_paths
from repro_torch.analysis.findings import Finding

__all__ = ["Finding", "analyze_paths", "tags"]
