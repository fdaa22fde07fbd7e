"""The fields of the JAX package's ``ArchSpec`` that the port's configs use."""
from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class ArchSpec:
    """One selectable architecture: model layout + training policy."""
    arch_id: str
    kind: str                      # population
    model: object                  # Population | LayeredPopulation
    optimizer: str = "adamw"
    lr: float = 3e-4
    source: str = ""
    notes: str = ""
