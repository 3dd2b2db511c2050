"""Qwen3-32B [hf:Qwen/Qwen3-8B family scaling].

64L d_model=5120 64H (GQA kv=8, head_dim=128) d_ff=25600 vocab=151936,
per-head q/k RMSNorm (qk_norm), full attention.
"""
from repro_torch.config import ModelConfig, register_arch

ARCH_ID = "qwen3-32b"


def full() -> ModelConfig:
    return ModelConfig(
        name=ARCH_ID,
        family="dense",
        source="hf:Qwen/Qwen3-8B",
        num_layers=64,
        d_model=5120,
        num_heads=64,
        num_kv_heads=8,
        head_dim=128,
        d_ff=25600,
        vocab_size=151936,
        qk_norm=True,
        rope_theta=1000000.0,
    )


def smoke() -> ModelConfig:
    return ModelConfig(
        name=ARCH_ID + "-smoke",
        family="dense",
        num_layers=2,
        d_model=128,
        num_heads=4,
        num_kv_heads=2,
        d_ff=256,
        vocab_size=512,
        qk_norm=True,
    )


register_arch(ARCH_ID, full, smoke)
