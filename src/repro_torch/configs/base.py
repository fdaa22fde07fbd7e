"""The fields of the JAX package's ``ArchSpec`` that the port's configs use
(``repro/configs/base.py``; the dry-run's shape grid stays there)."""
from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class ArchSpec:
    """One selectable ``--arch``: model config + training/serving policy."""
    arch_id: str
    kind: str                      # lm | population
    model: object                  # LMConfig | Population | LayeredPopulation
    optimizer: str = "adamw"
    optimizer_kw: tuple = ()       # (key, value) pairs (hashability)
    lr: float = 3e-4
    grad_accum_dtype: str = "float32"   # 'bfloat16' halves accumulators
    # per-shape gradient-accumulation counts (activation-memory policy)
    num_micro: tuple = ()          # ((shape_name, n), ...)
    skip_shapes: tuple = ()        # assigned shapes this arch cannot run
    skip_reason: str = ""
    source: str = ""               # [arXiv/hf ref; verification tier]
    notes: str = ""

    def micro_for(self, shape_name: str) -> int:
        return dict(self.num_micro).get(shape_name, 1)

    def runs(self, shape_name: str) -> bool:
        return shape_name not in self.skip_shapes

    def optimizer_kwargs(self) -> dict:
        return dict(self.optimizer_kw)
