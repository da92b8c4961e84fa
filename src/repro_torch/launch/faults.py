"""Fault injection for the continuous-batching pool (port of
``repro.launch.faults``).

A :class:`FaultPlan` is a deterministic, seeded script of failures that
``ContinuousBatcher`` applies at segment boundaries: the way to show that
the recovery paths (sentinel, quarantine and re-prefill, deadlines,
snapshot and restore) work end to end, and to replay a failure offline.

Event kinds (``FaultEvent.kind``):

* ``"nan"``   - set every float cache leaf of pool row ``row`` to NaN
  before segment ``segment`` runs (``row = -1`` picks a seeded row);
* ``"drop"``  - drop request ``rid`` (a client cancel): it leaves its slot
  or the queue with status ``failed``;
* ``"delay"`` - sleep ``seconds`` inside the segment's timed window;
* ``"kill"``  - raise :class:`SimulatedCrash` at the boundary; the caller
  restores from the last pool snapshot (``serve.py --restore``).

Plans serialize to and from JSON (``--fault-plan`` takes a path or an
inline JSON literal)::

    {"seed": 0, "events": [{"kind": "nan", "segment": 2, "row": 1},
                           {"kind": "kill", "segment": 4}]}

Seeds go through ``numpy`` as in the reference, so a plan picks the same
row in both packages.
"""
from __future__ import annotations

import dataclasses
import json
import os
from typing import Optional

import numpy as np
import torch

from repro_torch.core.engine import rows_mask
from repro_torch.distributed.sharding import is_dtensor, map_rows
from repro_torch.tree import map_with_path

FAULT_KINDS = ("nan", "drop", "delay", "kill")


class SimulatedCrash(RuntimeError):
    """Raised by a ``kill`` event: the serving loop 'crashed' at segment
    boundary ``segment``; the caller resumes from the last snapshot
    (``ContinuousBatcher.run(resume=True)``)."""

    def __init__(self, segment: int):
        super().__init__(f"simulated crash at segment boundary {segment}")
        self.segment = segment


@dataclasses.dataclass(frozen=True)
class FaultEvent:
    """One scripted failure, fired at the boundary before segment
    ``segment`` runs (0-based: ``segment=0`` fires before any decode)."""
    kind: str
    segment: int
    row: int = -1          # nan: pool row (-1 = a seeded active row)
    rid: int = -1          # drop: request id
    seconds: float = 0.0   # delay: sleep duration

    def __post_init__(self):
        if self.kind not in FAULT_KINDS:
            raise ValueError(f"unknown fault kind {self.kind!r}; "
                             f"expected one of {FAULT_KINDS}")
        if self.segment < 0:
            raise ValueError("fault segment must be >= 0")


@dataclasses.dataclass
class FaultPlan:
    """A deterministic schedule of :class:`FaultEvent` s.  ``seed`` drives
    the random choices (``row = -1`` targets), so a plan replays the same
    way run after run."""
    events: list = dataclasses.field(default_factory=list)
    seed: int = 0

    def __post_init__(self):
        self.events = [e if isinstance(e, FaultEvent) else FaultEvent(**e)
                       for e in self.events]
        self._rng = np.random.RandomState(self.seed)

    def at(self, segment: int) -> list:
        """Events scheduled for the given segment boundary, in order."""
        return [e for e in self.events if e.segment == segment]

    def pick_row(self, event: FaultEvent, slots: int,
                 active: Optional[np.ndarray] = None) -> int:
        """The event's target row; ``row = -1`` draws a seeded row,
        preferring the active ones."""
        if event.row >= 0:
            return event.row
        if active is not None and active.any():
            cand = np.nonzero(active)[0]
        else:
            cand = np.arange(slots)
        return int(cand[self._rng.randint(len(cand))])

    def to_json(self) -> str:
        return json.dumps({"seed": self.seed,
                           "events": [dataclasses.asdict(e)
                                      for e in self.events]})

    @classmethod
    def from_json(cls, text: str) -> "FaultPlan":
        obj = json.loads(text)
        return cls(events=obj.get("events", []), seed=obj.get("seed", 0))

    @classmethod
    def load(cls, spec: str) -> "FaultPlan":
        """Parse a ``--fault-plan`` argument: a JSON file path or an
        inline JSON literal."""
        if os.path.exists(spec):
            with open(spec) as f:
                return cls.from_json(f.read())
        return cls.from_json(spec)


def poison_rows(caches, rows):
    """The pool caches with every float leaf of the given rows (slot
    indices, on axis 0 of every leaf) set to NaN; the caches passed in are
    not modified.  The worst legal corruption a row can suffer: the
    sentinel must find it and the quarantine must contain it."""
    idx = list(rows)

    def leaf(_, a):
        if not a.is_floating_point() or a.ndim < 1:
            return a
        if is_dtensor(a):      # a pool on a mesh: each rank its own rows
            mask = rows_mask(idx, a.shape[0], a.device)
            return map_rows(a, lambda loc, r: loc.masked_fill(
                mask[r].reshape((-1,) + (1,) * (loc.ndim - 1)),
                float("nan")))
        out = a.clone()
        out[torch.as_tensor(idx, dtype=torch.long, device=a.device)] = \
            float("nan")
        return out
    return map_with_path(leaf, caches)


__all__ = ["FaultEvent", "FaultPlan", "SimulatedCrash", "poison_rows",
           "FAULT_KINDS"]
