"""mixtral-8x22b [moe] — 56L d_model=6144 48H (GQA kv=8) vocab=32768.

8 experts top-2 (renormalised gates), d_expert=16384; SWA per assignment
(window 4096).  arXiv:2401.04088.  8 experts < 16-way mesh → 'tp' expert
sharding (expert inner dim over 'model'), the E<mesh dual of EP."""
from repro_torch.configs.base import ArchSpec
from repro_torch.models.lm import LayerSpec, LMConfig
from repro_torch.nn.attention import AttnConfig
from repro_torch.nn.ffn import MoEConfig

SWA = 4096


def config() -> ArchSpec:
    model = LMConfig(
        name="mixtral-8x22b", vocab=32_768, d_model=6144,
        layers=tuple(LayerSpec("attn", "moe", SWA) for _ in range(56)),
        attn=AttnConfig(d_model=6144, n_heads=48, n_kv_heads=8, d_head=128,
                        sliding_window=SWA, rope_theta=1e6),
        moe=MoEConfig(d_model=6144, d_expert=16_384, num_experts=8, top_k=2,
                      num_shared=0, renorm_topk=True, capacity_factor=1.25,
                      sharding="tp"),
        norm="rmsnorm", moe_impl="shard_map")
    return ArchSpec(
        arch_id="mixtral-8x22b", kind="lm", model=model,
        optimizer="adamw", optimizer_kw=(("state_dtype", "bfloat16"),),
        lr=2e-4,
        num_micro=(("train_4k", 8),),
        source="[arXiv:2401.04088; hf]",
        notes="TP-experts (8 < mesh 16): expert d_ff over 'model'; SWA makes "
              "long_500k legal (4096-slot ring KV).")


def reduced() -> ArchSpec:
    model = LMConfig(
        name="mixtral-reduced", vocab=263, d_model=64,
        layers=tuple(LayerSpec("attn", "moe", 16) for _ in range(3)),
        attn=AttnConfig(d_model=64, n_heads=4, n_kv_heads=2, d_head=16,
                        sliding_window=16),
        moe=MoEConfig(d_model=64, d_expert=64, num_experts=4, top_k=2,
                      renorm_topk=True, sharding="tp"),
        norm="rmsnorm", moe_impl="dense", param_dtype="float32", remat=False)
    return ArchSpec(arch_id="mixtral-8x22b", kind="lm", model=model,
                    optimizer="adamw", lr=1e-3)
