"""InternVL2-1B [arXiv:2404.16821] — language backbone (Qwen2-0.5B class).

24L d_model=896 14H (GQA kv=2) d_ff=4864 vocab=151655.  The InternViT
vision encoder + MLP projector are the STUB frontend (per the assignment
carve-out): ``input_specs()`` provides 256 precomputed patch embeddings.
"""
from repro_torch.config import ModelConfig, register_arch

ARCH_ID = "internvl2-1b"


def full() -> ModelConfig:
    return ModelConfig(
        name=ARCH_ID,
        family="vlm",
        source="arXiv:2404.16821",
        num_layers=24,
        d_model=896,
        num_heads=14,
        num_kv_heads=2,
        d_ff=4864,
        vocab_size=151655,
        frontend="vision",
        num_prefix_tokens=256,
        tie_embeddings=True,
        rope_theta=1000000.0,
    )


def smoke() -> ModelConfig:
    return ModelConfig(
        name=ARCH_ID + "-smoke",
        family="vlm",
        num_layers=2,
        d_model=128,
        num_heads=4,
        num_kv_heads=2,
        d_ff=256,
        vocab_size=512,
        frontend="vision",
        num_prefix_tokens=8,
        tie_embeddings=True,
    )


register_arch(ARCH_ID, full, smoke)
