"""Architecture registry: ``--arch <id>`` resolution for the port.

The paper's population experiment and the JAX package's seven attention
LMs; the SSM and hybrid LMs (mamba2-780m, hymba-1.5b) and the
encoder-decoder (whisper-small) are not ported yet (ROADMAP.md, Queue 1
items 9(b) and 9(c))."""
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
    "parallelmlp-10k": "parallelmlp_10k",
}
_UNPORTED = {
    "mamba2-780m": "the SSM LM, ROADMAP.md Queue 1 item 9(b)",
    "hymba-1.5b": "the hybrid attention + SSM LM, ROADMAP.md Queue 1 item "
                  "9(b)",
    "whisper-small": "the encoder-decoder, ROADMAP.md Queue 1 item 9(c)",
}
LM_ARCH_IDS = tuple(k for k in _MODULES if k != "parallelmlp-10k")


def get_arch(arch_id: str, reduced: bool = False):
    if arch_id in _UNPORTED:
        raise NotImplementedError(
            f"arch {arch_id!r} is not ported yet ({_UNPORTED[arch_id]})")
    if arch_id not in _MODULES:
        raise KeyError(f"unknown arch {arch_id!r}; known: "
                       f"{sorted(_MODULES) + sorted(_UNPORTED)}")
    mod = importlib.import_module(f"repro_torch.configs.{_MODULES[arch_id]}")
    return mod.reduced() if reduced else mod.config()
