"""deepseek-moe-16b [moe] — 28L d_model=2048 16H (MHA, kv=16) vocab=102400.

Fine-grained MoE: 64 routed experts top-6 + 2 shared, d_expert=1408;
layer 0 uses a dense FFN (d_ff=10944, per HF config).  arXiv:2401.06066.
EP: 64 experts shard over the 16-way 'model' axis (all-to-all dispatch) —
the paper's M3/grouped-GEMM trick is this layer's compute core."""
from repro_torch.configs.base import ArchSpec
from repro_torch.models.lm import LayerSpec, LMConfig
from repro_torch.nn.attention import AttnConfig
from repro_torch.nn.ffn import FFNConfig, MoEConfig


def config() -> ArchSpec:
    model = LMConfig(
        name="deepseek-moe-16b", vocab=102_400, d_model=2048,
        layers=(LayerSpec("attn", "dense", 0),)
        + tuple(LayerSpec("attn", "moe", 0) for _ in range(27)),
        attn=AttnConfig(d_model=2048, n_heads=16, n_kv_heads=16, d_head=128,
                        rope_theta=1e4),
        dense_ffn0=FFNConfig(2048, 10_944, act="silu", gated=True),
        moe=MoEConfig(d_model=2048, d_expert=1408, num_experts=64, top_k=6,
                      num_shared=2, renorm_topk=False, capacity_factor=1.25,
                      aux_loss_coef=0.001, sharding="ep"),
        norm="rmsnorm", moe_impl="shard_map")
    return ArchSpec(
        arch_id="deepseek-moe-16b", kind="lm", model=model,
        optimizer="adamw", lr=4.2e-4,
        num_micro=(("train_4k", 2),),
        skip_shapes=("long_500k",),
        skip_reason="full attention: 512k dense KV cache has no "
                    "sub-quadratic lowering (DESIGN.md §shape-skips)",
        source="[arXiv:2401.06066; hf]",
        notes="EP=16 all-to-all MoE (paper's M3 row-segment dual); "
              "2 shared experts TP via shared FFN.")


def reduced() -> ArchSpec:
    model = LMConfig(
        name="deepseek-moe-reduced", vocab=269, d_model=64,
        layers=(LayerSpec("attn", "dense", 0),)
        + tuple(LayerSpec("attn", "moe", 0) for _ in range(2)),
        attn=AttnConfig(d_model=64, n_heads=4, n_kv_heads=4, d_head=16),
        dense_ffn0=FFNConfig(64, 128, act="silu", gated=True),
        moe=MoEConfig(d_model=64, d_expert=32, num_experts=8, top_k=2,
                      num_shared=2, renorm_topk=False, sharding="ep"),
        norm="rmsnorm", moe_impl="dense", param_dtype="float32", remat=False)
    return ArchSpec(arch_id="deepseek-moe-16b", kind="lm", model=model,
                    optimizer="adamw", lr=1e-3)
