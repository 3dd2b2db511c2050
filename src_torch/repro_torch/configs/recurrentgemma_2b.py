"""RecurrentGemma-2B [arXiv:2402.19427] (Griffin architecture).

26L d_model=2560, pattern (rglru, rglru, local-attention) 1:2 attention to
recurrence, 10H MQA (kv=1) local window 2048, GeGLU d_ff=7680,
vocab=256000, RG-LRU width 2560.  Sub-quadratic => runs long_500k.
The port's first model with RG-LRU blocks and head dim 256.
"""
from repro_torch.config import LOCAL_ATTN, RGLRU, ModelConfig, register_arch

ARCH_ID = "recurrentgemma-2b"


def full() -> ModelConfig:
    return ModelConfig(
        name=ARCH_ID,
        family="hybrid",
        source="arXiv:2402.19427",
        num_layers=26,
        d_model=2560,
        num_heads=10,
        num_kv_heads=1,
        head_dim=256,
        d_ff=7680,
        vocab_size=256000,
        act="gelu",
        block_pattern=(RGLRU, RGLRU, LOCAL_ATTN),
        window=2048,
        lru_width=2560,
        conv_width=4,
        tie_embeddings=True,
        logits_softcap=30.0,
    )


def smoke() -> ModelConfig:
    return ModelConfig(
        name=ARCH_ID + "-smoke",
        family="hybrid",
        num_layers=3,
        d_model=128,
        num_heads=4,
        num_kv_heads=1,
        head_dim=32,
        d_ff=256,
        vocab_size=512,
        act="gelu",
        block_pattern=(RGLRU, RGLRU, LOCAL_ATTN),
        window=16,
        lru_width=128,
        tie_embeddings=True,
        logits_softcap=30.0,
    )


register_arch(ARCH_ID, full, smoke)
