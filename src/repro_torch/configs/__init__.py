"""Architecture registry: ``--arch <id>`` resolution for the port.

The paper's population experiment and the JAX package's nine decoder
LMs: seven attention LMs (``LM_ARCH_IDS``) and the SSM and hybrid LMs
(``SSM_ARCH_IDS``: mamba2-780m, hymba-1.5b).  The encoder-decoder
(whisper-small) is not ported yet (ROADMAP.md, Queue 1 item 9(c))."""
from __future__ import annotations

import importlib

_MODULES = {
    "deepseek-moe-16b": "deepseek_moe_16b",
    "mixtral-8x22b": "mixtral_8x22b",
    "h2o-danube-3-4b": "h2o_danube_3_4b",
    "command-r-35b": "command_r_35b",
    "nemotron-4-340b": "nemotron_4_340b",
    "qwen3-1.7b": "qwen3_1_7b",
    "qwen2-vl-72b": "qwen2_vl_72b",
    "mamba2-780m": "mamba2_780m",
    "hymba-1.5b": "hymba_1_5b",
    "parallelmlp-10k": "parallelmlp_10k",
}
_UNPORTED = {
    "whisper-small": "the encoder-decoder, ROADMAP.md Queue 1 item 9(c)",
}
SSM_ARCH_IDS = ("mamba2-780m", "hymba-1.5b")   # an SSM path in every layer
LM_ARCH_IDS = tuple(k for k in _MODULES
                    if k != "parallelmlp-10k" and k not in SSM_ARCH_IDS)


def get_arch(arch_id: str, reduced: bool = False):
    if arch_id in _UNPORTED:
        raise NotImplementedError(
            f"arch {arch_id!r} is not ported yet ({_UNPORTED[arch_id]})")
    if arch_id not in _MODULES:
        raise KeyError(f"unknown arch {arch_id!r}; known: "
                       f"{sorted(_MODULES) + sorted(_UNPORTED)}")
    mod = importlib.import_module(f"repro_torch.configs.{_MODULES[arch_id]}")
    return mod.reduced() if reduced else mod.config()
