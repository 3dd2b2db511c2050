"""Granite 34B Code [arXiv:2405.04324].

88L d_model=6144 48H (MQA kv=1) d_ff=24576 vocab=49152 — code model,
llama-arch trunk with multi-query attention.  Deepest assigned arch; the
scan-over-layers trunk keeps its HLO the same size as a 2-layer model's.
"""
from repro_torch.config import ModelConfig, register_arch

ARCH_ID = "granite-34b"


def full() -> ModelConfig:
    return ModelConfig(
        name=ARCH_ID,
        family="dense",
        source="arXiv:2405.04324",
        num_layers=88,
        d_model=6144,
        num_heads=48,
        num_kv_heads=1,
        d_ff=24576,
        vocab_size=49152,
        act="gelu",
        gated_mlp=False,   # GPTBigCode-style 2-matrix MLP => ~34B as published
    )


def smoke() -> ModelConfig:
    return ModelConfig(
        name=ARCH_ID + "-smoke",
        family="dense",
        num_layers=2,
        d_model=128,
        num_heads=4,
        num_kv_heads=1,
        d_ff=256,
        vocab_size=512,
    )


register_arch(ARCH_ID, full, smoke)
