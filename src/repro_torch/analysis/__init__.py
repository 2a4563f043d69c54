"""Static and runtime analysis plane of the port.

- ``analysis.tags`` — annotation registry (party / wire / accounting /
  hot_loop / host_boundary decorators) the static passes read off the AST.
- ``analysis.boundary`` — party-boundary leak rules (PB1xx).
- ``analysis.jitlint`` — trace-hygiene rules (TH2xx) for CUDA-graph
  captured steps and the serve plane's hot loops.
- ``analysis.runtime`` — the host-read and recompile sentinels and the
  ``strict()`` context manager.
- ``analysis.marks`` / ``analysis.ifc`` / ``analysis.certify`` — the
  graph-level certifier: boundary marks (identities outside its trace),
  the taint pass over ``make_fx`` graphs (IF301–IF303) and the driver
  over every shipped configuration (IF304).
- ``python -m repro_torch.analysis --strict`` — the gate over the port's
  own source; ``python -m repro_torch.analysis certify`` — the
  certifier.
"""

from repro_torch.analysis import tags
from repro_torch.analysis.cli import analyze_paths
from repro_torch.analysis.findings import Finding

__all__ = ["Finding", "analyze_paths", "tags"]
