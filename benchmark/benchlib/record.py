"""What one run of a cell recorded, as the metric readers see it."""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional

from .devtrace import TraceSummary


@dataclasses.dataclass
class Request:
    """One request of the window, timed on the host clock from the
    hand-over of its input to its answer on the host."""
    mesh: int            # index into the pool
    n: int               # nodes
    e: int               # message-passing edges (off-diagonal nonzeros)
    seconds: float       # the whole request
    graph_s: float       # node order, graph build and copy to the card
    fw_launches: int     # forward-kernel launches it made
    profiled: bool = False


@dataclasses.dataclass
class Step:
    """One training step of the window, timed on the host clock from its
    call to its loss on the host."""
    samples: int         # meshes (samples) in the batch
    seconds: float
    loss: float
    fw_launches: int     # forward-kernel launches it made
    bw_launches: int     # backward-kernel (VJP) launches it made
    profiled: bool = False


@dataclasses.dataclass
class Run:
    cell: str
    config: dict
    traffic: dict
    reference: Any                       # the configuration's reference module
    setup_s: float = 0.0
    window_s: float = 0.0
    requests: List[Request] = dataclasses.field(default_factory=list)
    steps: List[Step] = dataclasses.field(default_factory=list)
    trace: Optional[TraceSummary] = None
    profiled: List[Request] = dataclasses.field(default_factory=list)
    failed: int = 0
    judged: List[dict] = dataclasses.field(default_factory=list)
    checks: Dict[str, Dict[str, float]] = dataclasses.field(
        default_factory=dict)
    memory_peak_bytes: int = 0

    @property
    def timed(self) -> List[Request]:
        """The window's requests that ran outside the profiled slice."""
        return [r for r in self.requests if not r.profiled]

    @property
    def correct(self) -> bool:
        return (self.failed == 0 and bool(self.checks) and all(
            c["value"] <= c["limit"] for c in self.checks.values()))
