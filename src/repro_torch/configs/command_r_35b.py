"""command-r-35b [dense] — 40L d_model=8192 64H (GQA kv=8) d_ff=22528.

Cohere c4ai-command-r-v01: LayerNorm (no bias), PARALLEL attn+FFN blocks
(single input norm), no biases anywhere, tied embeddings with logit_scale
0.0625, vocab 256000, rope_theta 8e6."""
from repro_torch.configs.base import ArchSpec
from repro_torch.models.lm import LayerSpec, LMConfig
from repro_torch.nn.attention import AttnConfig
from repro_torch.nn.ffn import FFNConfig


def config() -> ArchSpec:
    model = LMConfig(
        name="command-r-35b", vocab=256_000, d_model=8192,
        layers=tuple(LayerSpec("attn", "dense", 0) for _ in range(40)),
        attn=AttnConfig(d_model=8192, n_heads=64, n_kv_heads=8, d_head=128,
                        rope_theta=8e6),
        ffn=FFNConfig(8192, 22_528, act="silu", gated=True),
        norm="layernorm", parallel_block=True, tie_embeddings=True,
        logit_scale=0.0625)
    return ArchSpec(
        arch_id="command-r-35b", kind="lm", model=model,
        optimizer="adamw", optimizer_kw=(("state_dtype", "bfloat16"),),
        lr=2.5e-4,
        num_micro=(("train_4k", 4),),
        skip_shapes=("long_500k",),
        skip_reason="full attention: 512k dense KV cache has no "
                    "sub-quadratic lowering (DESIGN.md §shape-skips)",
        source="[hf:CohereForAI/c4ai-command-r-v01; unverified]",
        notes="parallel residual block; 256k vocab shards over 'model' "
              "(16k rows/chip) for embed+logits.")


def reduced() -> ArchSpec:
    model = LMConfig(
        name="command-r-reduced", vocab=277, d_model=64,
        layers=tuple(LayerSpec("attn", "dense", 0) for _ in range(3)),
        attn=AttnConfig(d_model=64, n_heads=4, n_kv_heads=2, d_head=16),
        ffn=FFNConfig(64, 128, act="silu", gated=True),
        norm="layernorm", parallel_block=True, tie_embeddings=True,
        logit_scale=0.0625, param_dtype="float32", remat=False)
    return ArchSpec(arch_id="command-r-35b", kind="lm", model=model,
                    optimizer="adamw", lr=1e-3)
