"""Yi-34B [arXiv:2403.04652].

60L d_model=7168 56H (GQA kv=8) d_ff=20480 vocab=64000 — llama-style GQA,
full attention (long_500k skipped per DESIGN.md).
"""
from repro_torch.config import ModelConfig, register_arch

ARCH_ID = "yi-34b"


def full() -> ModelConfig:
    return ModelConfig(
        name=ARCH_ID,
        family="dense",
        source="arXiv:2403.04652",
        num_layers=60,
        d_model=7168,
        num_heads=56,
        num_kv_heads=8,
        d_ff=20480,
        vocab_size=64000,
        rope_theta=5000000.0,
    )


def smoke() -> ModelConfig:
    return ModelConfig(
        name=ARCH_ID + "-smoke",
        family="dense",
        num_layers=2,
        d_model=128,
        num_heads=8,
        num_kv_heads=2,
        d_ff=256,
        vocab_size=512,
    )


register_arch(ARCH_ID, full, smoke)
