"""The one general traffic generator: a mix is a JSON file of parameters.

``benchmark/traffic/<mix>.json`` sets any of these (a key not listed is
refused, so a misspelt one cannot pass unnoticed):

  churn_share    share of the objects given 1..8 more desired replicas
                 each tick (``world.churn``); the list accumulates.
  respec         true: two generations of every object alternate, the
                 second made by ``world.respec``, so every row changes
                 every tick.
  drift_members  members whose free capacity is halved (``world.drift``)
                 on even ticks, drawn from the seed each time; odd ticks
                 restore the members' first state.

Tick 0 is the first after the cold tick, which schedules the world as
built.  The generator owns the records; the harness applies each step to
the program's objects.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional

import numpy as np

from benchmark import world

KEYS = {"churn_share", "respec", "drift_members"}


@dataclass
class Step:
    """One tick's change: ``changed`` rows' new records, or the
    generation whose records every row takes; the cluster records when
    they changed (None: as before) and the members drifted."""

    changed: dict = field(default_factory=dict)
    generation: Optional[int] = None
    clusters: Optional[list] = None
    drifted: tuple = ()


class Traffic:
    def __init__(self, params: dict, units: list, clusters: list, rng: np.random.Generator):
        unknown = set(params) - KEYS
        if unknown:
            raise ValueError(f"unknown traffic keys {sorted(unknown)}; valid: {sorted(KEYS)}")
        self.churn_share = float(params.get("churn_share", 0.0))
        self.drift_members = int(params.get("drift_members", 0))
        self.generations = [units, world.respec(units)] if params.get("respec") else None
        if self.generations and self.churn_share:
            raise ValueError("respec and churn_share both change every object's spec")
        self.rng = rng
        self.units = units
        self.base_clusters = clusters
        self.clusters = clusters
        self.t = 0

    @property
    def period(self) -> int:
        """Ticks after which the mix's kinds of tick repeat."""
        return 2 if self.generations or self.drift_members else 1

    def step(self) -> Step:
        t, self.t = self.t, self.t + 1
        out = Step()
        if self.generations:
            out.generation = (t + 1) % 2
            self.units = self.generations[out.generation]
        elif self.churn_share:
            out.changed = world.churn(self.rng, self.units, self.churn_share)
            self.units = list(self.units)
            for i, rec in out.changed.items():
                self.units[i] = rec
        if self.drift_members:
            if t % 2 == 0:
                members = self.rng.choice(len(self.base_clusters), self.drift_members, replace=False)
                out.drifted = tuple(int(m) for m in members)
                out.clusters = list(self.base_clusters)
                for m in out.drifted:
                    out.clusters[m] = world.drift(self.base_clusters[m])
            else:
                out.clusters = list(self.base_clusters)
            self.clusters = out.clusters
        return out
