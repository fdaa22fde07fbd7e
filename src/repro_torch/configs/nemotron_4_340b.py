"""nemotron-4-340b [dense] — 96L d_model=18432 96H (GQA kv=8) d_ff=73728.

arXiv:2402.16819: squared-ReLU non-gated FFN, no biases, untied embeddings,
vocab 256000, LayerNorm.  340B params → adafactor (factored v, bf16 m):
param+opt state = 340B×(2+2) + factored stats ≈ 1.4 TB → 5.6 GB/chip at 256
chips; activations held down by 16-way microbatching + SP residual + remat."""
from repro_torch.configs.base import ArchSpec
from repro_torch.models.lm import LayerSpec, LMConfig
from repro_torch.nn.attention import AttnConfig
from repro_torch.nn.ffn import FFNConfig


def config() -> ArchSpec:
    model = LMConfig(
        name="nemotron-4-340b", vocab=256_000, d_model=18_432,
        layers=tuple(LayerSpec("attn", "dense", 0) for _ in range(96)),
        attn=AttnConfig(d_model=18_432, n_heads=96, n_kv_heads=8, d_head=192,
                        rope_theta=1e4),
        ffn=FFNConfig(18_432, 73_728, act="relu2", gated=False),
        norm="layernorm")
    return ArchSpec(
        arch_id="nemotron-4-340b", kind="lm", model=model,
        optimizer="adafactor", lr=1.2e-4,
        grad_accum_dtype="bfloat16",   # §Perf iter 5: halve grad buffers
        # 8 microbatches: 32 seqs each — divisible by BOTH dp widths
        # (16 single-pod, 32 multi-pod); 16 would leave multi-pod batches
        # unshardable (replicated activations blew past HBM)
        num_micro=(("train_4k", 8),),
        skip_shapes=("long_500k",),
        skip_reason="full attention: 512k dense KV cache has no "
                    "sub-quadratic lowering (DESIGN.md §shape-skips)",
        source="[arXiv:2402.16819; unverified]",
        notes="the memory-pressure stress arch: FSDP('data') × TP('model') "
              "2D param sharding, adafactor, 16 microbatches.")


def reduced() -> ArchSpec:
    model = LMConfig(
        name="nemotron-reduced", vocab=283, d_model=64,
        layers=tuple(LayerSpec("attn", "dense", 0) for _ in range(3)),
        attn=AttnConfig(d_model=64, n_heads=4, n_kv_heads=2, d_head=16),
        ffn=FFNConfig(64, 128, act="relu2", gated=False),
        norm="layernorm", param_dtype="float32", remat=False)
    return ArchSpec(arch_id="nemotron-4-340b", kind="lm", model=model,
                    optimizer="adafactor", lr=1e-3)
