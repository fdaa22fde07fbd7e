"""h2o-danube-3-4b [dense] — 24L d_model=3840 32H (GQA kv=8) d_ff=10240.

llama+mistral mix with SWA (window 4096 per assignment), vocab 32000.
arXiv:2401.16818.  d_head = 120 (3840/32)."""
from repro_torch.configs.base import ArchSpec
from repro_torch.models.lm import LayerSpec, LMConfig
from repro_torch.nn.attention import AttnConfig
from repro_torch.nn.ffn import FFNConfig

SWA = 4096


def config() -> ArchSpec:
    model = LMConfig(
        name="h2o-danube-3-4b", vocab=32_000, d_model=3840,
        layers=tuple(LayerSpec("attn", "dense", SWA) for _ in range(24)),
        attn=AttnConfig(d_model=3840, n_heads=32, n_kv_heads=8, d_head=120,
                        sliding_window=SWA, rope_theta=5e5),
        ffn=FFNConfig(3840, 10_240, act="silu", gated=True),
        norm="rmsnorm")
    return ArchSpec(
        arch_id="h2o-danube-3-4b", kind="lm", model=model,
        optimizer="adamw", lr=3e-4,
        num_micro=(("train_4k", 2),),
        source="[arXiv:2401.16818; unverified]",
        notes="SWA ring KV bounds the cache → long_500k legal.")


def reduced() -> ArchSpec:
    model = LMConfig(
        name="danube-reduced", vocab=271, d_model=64,
        layers=tuple(LayerSpec("attn", "dense", 16) for _ in range(3)),
        attn=AttnConfig(d_model=64, n_heads=4, n_kv_heads=2, d_head=16,
                        sliding_window=16),
        ffn=FFNConfig(64, 128, act="silu", gated=True),
        norm="rmsnorm", param_dtype="float32", remat=False)
    return ArchSpec(arch_id="h2o-danube-3-4b", kind="lm", model=model,
                    optimizer="adamw", lr=1e-3)
