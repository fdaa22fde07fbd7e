"""mamba2-780m [ssm] — 48L d_model=1536, attention-free, ssm_state=128.

SSD (state-space duality), arXiv:2405.21060.  No FFN (pure Mamba2 stack,
d_ff=0 per assignment); tied embeddings, RMSNorm, vocab 50280 (GPT-NeoX).
O(1) recurrent decode state."""
from repro_torch.configs.base import ArchSpec
from repro_torch.models.lm import LayerSpec, LMConfig
from repro_torch.nn.ssm import SSMConfig


def config() -> ArchSpec:
    model = LMConfig(
        name="mamba2-780m", vocab=50_280, d_model=1536,
        layers=tuple(LayerSpec("ssm", "none", 0) for _ in range(48)),
        ssm=SSMConfig(d_model=1536, d_state=128, d_conv=4, expand=2,
                      head_dim=64, n_groups=1, chunk=256),
        norm="rmsnorm", tie_embeddings=True)
    return ArchSpec(
        arch_id="mamba2-780m", kind="lm", model=model,
        optimizer="adamw", lr=6e-4,
        num_micro=(("train_4k", 2),),
        source="[arXiv:2405.21060; unverified]",
        notes="SSD chunked scan, plain PyTorch (the JAX package's is "
              "einsums, no Pallas kernel).")


def reduced() -> ArchSpec:
    model = LMConfig(
        name="mamba2-reduced", vocab=257, d_model=64,
        layers=tuple(LayerSpec("ssm", "none", 0) for _ in range(3)),
        ssm=SSMConfig(d_model=64, d_state=16, d_conv=4, expand=2,
                      head_dim=16, n_groups=1, chunk=16),
        norm="rmsnorm", tie_embeddings=True, param_dtype="float32",
        remat=False)
    return ArchSpec(arch_id="mamba2-780m", kind="lm", model=model,
                    optimizer="adamw", lr=1e-3)
