"""Architecture registry: ``--arch <id>`` resolution for the port.

The port carries the paper's population experiment; the JAX package's LM
architectures belong to the LM side stack, not ported yet (ROADMAP.md)."""
from __future__ import annotations

import importlib

_MODULES = {"parallelmlp-10k": "parallelmlp_10k"}


def get_arch(arch_id: str, reduced: bool = False):
    if arch_id not in _MODULES:
        raise NotImplementedError(
            f"arch {arch_id!r}: the port has {sorted(_MODULES)}; the LM "
            "architectures are the LM side stack, not ported yet "
            "(ROADMAP.md, Queue 1)")
    mod = importlib.import_module(f"repro_torch.configs.{_MODULES[arch_id]}")
    return mod.reduced() if reduced else mod.config()
