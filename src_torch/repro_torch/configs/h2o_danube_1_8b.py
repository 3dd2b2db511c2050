"""H2O-Danube 1.8B [arXiv:2401.16818].

24L d_model=2560 32H (GQA kv=8) d_ff=6912 vocab=32000; llama+mistral mix
with sliding-window attention (window 4096).  Sub-quadratic at decode =>
runs the long_500k shape.
"""
from repro_torch.config import ModelConfig, register_arch

ARCH_ID = "h2o-danube-1.8b"


def full() -> ModelConfig:
    return ModelConfig(
        name=ARCH_ID,
        family="dense",
        source="arXiv:2401.16818",
        num_layers=24,
        d_model=2560,
        num_heads=32,
        num_kv_heads=8,
        d_ff=6912,
        vocab_size=32000,
        window=4096,
        rope_theta=10000.0,
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
        window=16,
    )


register_arch(ARCH_ID, full, smoke)
