"""hymba-1.5b [hybrid] — 32L d_model=1600 25H (GQA kv=5) d_ff=5504,
ssm_state=16.

arXiv:2411.13676: every layer runs attention heads AND Mamba heads in
PARALLEL on the same input, their outputs fused (``nn.hybrid``).  Window
pattern per Hymba: global attention at layers 0/15/31, SWA 1024
elsewhere.  d_head=64; SSM: expand 2 → d_inner 3200, 50 SSD heads, state
16.  Meta-tokens omitted, as in the JAX package."""
from repro_torch.configs.base import ArchSpec
from repro_torch.models.lm import LayerSpec, LMConfig
from repro_torch.nn.attention import AttnConfig
from repro_torch.nn.ffn import FFNConfig
from repro_torch.nn.ssm import SSMConfig

SWA = 1024
GLOBAL_LAYERS = (0, 15, 31)


def config() -> ArchSpec:
    layers = tuple(
        LayerSpec("hybrid", "dense", 0 if i in GLOBAL_LAYERS else SWA)
        for i in range(32))
    model = LMConfig(
        name="hymba-1.5b", vocab=32_001, d_model=1600,
        layers=layers,
        attn=AttnConfig(d_model=1600, n_heads=25, n_kv_heads=5, d_head=64,
                        rope_theta=1e4),
        ssm=SSMConfig(d_model=1600, d_state=16, d_conv=4, expand=2,
                      head_dim=64, n_groups=1, chunk=256),
        ffn=FFNConfig(1600, 5504, act="silu", gated=True),
        norm="rmsnorm", tie_embeddings=True)
    return ArchSpec(
        arch_id="hymba-1.5b", kind="lm", model=model,
        optimizer="adamw", lr=5e-4,
        num_micro=(("train_4k", 2), ("long_500k", 1)),
        source="[arXiv:2411.13676; hf]",
        notes="the paper's fusion inside one layer (attn ∥ SSM heads); every "
              "layer's attention one flash launch a forward.")


def reduced() -> ArchSpec:
    layers = tuple(LayerSpec("hybrid", "dense", 0 if i == 0 else 16)
                   for i in range(3))
    model = LMConfig(
        name="hymba-reduced", vocab=313, d_model=64,
        layers=layers,
        attn=AttnConfig(d_model=64, n_heads=4, n_kv_heads=2, d_head=16),
        ssm=SSMConfig(d_model=64, d_state=16, d_conv=4, expand=2,
                      head_dim=16, n_groups=1, chunk=16),
        ffn=FFNConfig(64, 128, act="silu", gated=True),
        norm="rmsnorm", tie_embeddings=True, param_dtype="float32",
        remat=False)
    return ArchSpec(arch_id="hymba-1.5b", kind="lm", model=model,
                    optimizer="adamw", lr=1e-3)
