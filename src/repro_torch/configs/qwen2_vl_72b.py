"""qwen2-vl-72b [vlm] — 80L d_model=8192 64H (GQA kv=8) d_ff=29568.

arXiv:2409.12191.  Transformer BACKBONE only per assignment: the vision
frontend (dynamic-resolution ViT) is a STUB — input_specs() provides
precomputed patch embeddings (B, S, d_model).  M-RoPE with sections
(16, 24, 24) over the 64 head_dim/2 frequency bands; qkv biases (qwen2),
vocab 152064, untied."""
from repro_torch.configs.base import ArchSpec
from repro_torch.models.lm import LayerSpec, LMConfig
from repro_torch.nn.attention import AttnConfig
from repro_torch.nn.ffn import FFNConfig


def config() -> ArchSpec:
    model = LMConfig(
        name="qwen2-vl-72b", vocab=152_064, d_model=8192,
        layers=tuple(LayerSpec("attn", "dense", 0) for _ in range(80)),
        attn=AttnConfig(d_model=8192, n_heads=64, n_kv_heads=8, d_head=128,
                        qkv_bias=True, rope_kind="mrope", rope_theta=1e6,
                        mrope_sections=(16, 24, 24)),
        ffn=FFNConfig(8192, 29_568, act="silu", gated=True),
        norm="rmsnorm", frontend="embeds")
    return ArchSpec(
        arch_id="qwen2-vl-72b", kind="lm", model=model,
        optimizer="adamw", optimizer_kw=(("state_dtype", "bfloat16"),),
        lr=2e-4,
        num_micro=(("train_4k", 8),),
        skip_shapes=("long_500k",),
        skip_reason="full attention: 512k dense KV cache has no "
                    "sub-quadratic lowering (DESIGN.md §shape-skips)",
        source="[arXiv:2409.12191; hf]",
        notes="patch-embedding frontend stub; M-RoPE streams degenerate to "
              "text positions in the stub (equality with RoPE tested).")


def reduced() -> ArchSpec:
    model = LMConfig(
        name="qwen2-vl-reduced", vocab=331, d_model=64,
        layers=tuple(LayerSpec("attn", "dense", 0) for _ in range(3)),
        attn=AttnConfig(d_model=64, n_heads=4, n_kv_heads=2, d_head=16,
                        qkv_bias=True, rope_kind="mrope",
                        mrope_sections=(2, 3, 3)),
        ffn=FFNConfig(64, 128, act="silu", gated=True),
        norm="rmsnorm", frontend="embeds", param_dtype="float32",
        remat=False)
    return ArchSpec(arch_id="qwen2-vl-72b", kind="lm", model=model,
                    optimizer="adamw", lr=1e-3)
