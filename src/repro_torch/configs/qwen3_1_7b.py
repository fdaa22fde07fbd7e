"""qwen3-1.7b [dense] — 28L d_model=2048 16H (GQA kv=8) d_ff=6144.

qk-norm (per-head RMS on q and k), tied embeddings, vocab 151936,
rope_theta 1e6.  [hf:Qwen/Qwen3-8B family].  Copied from the JAX
package's ``repro/configs/qwen3_1_7b.py``."""
from repro_torch.configs.base import ArchSpec
from repro_torch.models.lm import LayerSpec, LMConfig
from repro_torch.nn.attention import AttnConfig
from repro_torch.nn.ffn import FFNConfig


def config() -> ArchSpec:
    model = LMConfig(
        name="qwen3-1.7b", vocab=151_936, d_model=2048,
        layers=tuple(LayerSpec("attn", "dense", 0) for _ in range(28)),
        attn=AttnConfig(d_model=2048, n_heads=16, n_kv_heads=8, d_head=128,
                        qk_norm=True, rope_theta=1e6),
        ffn=FFNConfig(2048, 6144, act="silu", gated=True),
        # §Perf note: remat=False was tried (saves the 2·N·D recompute) and
        # REFUTED — 1M-token steps push saved activations to 100 GiB/chip;
        # full remat + the width-gated TP policy is the measured optimum
        norm="rmsnorm", tie_embeddings=True)
    return ArchSpec(
        arch_id="qwen3-1.7b", kind="lm", model=model,
        optimizer="adamw", lr=3e-4,
        skip_shapes=("long_500k",),
        skip_reason="full attention: 512k dense KV cache has no "
                    "sub-quadratic lowering (DESIGN.md §shape-skips)",
        source="[hf:Qwen/Qwen3-8B; hf]",
        notes="152k vocab dominates the 1.7B param count; logits are the "
              "compute hot-spot at train_4k.")


def reduced() -> ArchSpec:
    model = LMConfig(
        name="qwen3-reduced", vocab=293, d_model=64,
        layers=tuple(LayerSpec("attn", "dense", 0) for _ in range(3)),
        attn=AttnConfig(d_model=64, n_heads=4, n_kv_heads=2, d_head=16,
                        qk_norm=True),
        ffn=FFNConfig(64, 128, act="silu", gated=True),
        norm="rmsnorm", tie_embeddings=True, param_dtype="float32",
        remat=False)
    return ArchSpec(arch_id="qwen3-1.7b", kind="lm", model=model,
                    optimizer="adamw", lr=1e-3)
