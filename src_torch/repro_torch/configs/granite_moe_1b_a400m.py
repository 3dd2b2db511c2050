"""Granite-3.0 1B-A400M base [hf:ibm-granite/granite-3.0-1b-a400m-base].

24L d_model=1024 16H (GQA kv=8) vocab=49155, MoE 32 experts top-8,
per-expert d_ff=512.
"""
from repro_torch.config import ModelConfig, MoEConfig, register_arch

ARCH_ID = "granite-moe-1b-a400m"


def full() -> ModelConfig:
    return ModelConfig(
        name=ARCH_ID,
        family="moe",
        source="hf:ibm-granite/granite-3.0-1b-a400m-base",
        num_layers=24,
        d_model=1024,
        num_heads=16,
        num_kv_heads=8,
        d_ff=0,
        vocab_size=49155,
        moe=MoEConfig(num_experts=32, experts_per_token=8, d_ff=512,
                      capacity_factor=1.25),
        tie_embeddings=True,
    )


def smoke() -> ModelConfig:
    return ModelConfig(
        name=ARCH_ID + "-smoke",
        family="moe",
        num_layers=2,
        d_model=128,
        num_heads=4,
        num_kv_heads=2,
        d_ff=0,
        vocab_size=512,
        moe=MoEConfig(num_experts=4, experts_per_token=2, d_ff=64,
                      capacity_factor=1.5),
        tie_embeddings=True,
    )


register_arch(ARCH_ID, full, smoke)
