"""Whisper-medium [arXiv:2212.04356] — transformer backbone.

Enc-dec, 24+24L d_model=1024 16H d_ff=4096 vocab=51865.  The mel-spectrogram
+ conv feature extractor is the STUB frontend: ``input_specs()`` provides
1500 precomputed frame embeddings (30 s of audio after the conv stack's 2x
downsampling).  GeLU MLPs, LayerNorm (as in the original), MHA (kv=16).
"""
from repro_torch.config import ModelConfig, register_arch

ARCH_ID = "whisper-medium"


def full() -> ModelConfig:
    return ModelConfig(
        name=ARCH_ID,
        family="audio",
        source="arXiv:2212.04356",
        num_layers=24,
        d_model=1024,
        num_heads=16,
        num_kv_heads=16,
        d_ff=4096,
        vocab_size=51865,
        act="gelu",
        gated_mlp=False,   # Whisper uses plain GELU MLPs => ~769M as published
        norm="layernorm",
        is_encoder_decoder=True,
        num_encoder_layers=24,
        encoder_seq=1500,
        frontend="audio",
    )


def smoke() -> ModelConfig:
    return ModelConfig(
        name=ARCH_ID + "-smoke",
        family="audio",
        num_layers=2,
        d_model=128,
        num_heads=4,
        num_kv_heads=4,
        d_ff=256,
        vocab_size=512,
        act="gelu",
        norm="layernorm",
        is_encoder_decoder=True,
        num_encoder_layers=2,
        encoder_seq=32,
        frontend="audio",
    )


register_arch(ARCH_ID, full, smoke)
