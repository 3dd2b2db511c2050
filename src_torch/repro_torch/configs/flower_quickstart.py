"""The paper's own demo workload (§5.1): Flower PyTorch-Quickstart analogue
(port of ``repro/configs/flower_quickstart.py``).

A small decoder config used by the FL examples and the training launcher
(its default ``--arch``) -- *not* one of the 10 assigned architectures but
the paper's own experiment at its original scale.  Registered as
``flower-quickstart`` with a transformer-shaped smoke twin so every
registry entry supports the same tooling.
"""
from repro_torch.config import ModelConfig, register_arch

ARCH_ID = "flower-quickstart"


def full() -> ModelConfig:
    # a deliberately small decoder (the paper's demo model is ~100k params);
    # FL benchmarks use repro_torch.fl.quickstart's MLP for the CNN-like model
    return ModelConfig(
        name=ARCH_ID,
        family="dense",
        source="paper §5.1 (PyTorch quickstart analogue)",
        num_layers=4,
        d_model=256,
        num_heads=8,
        num_kv_heads=8,
        d_ff=1024,
        vocab_size=4096,
        remat=False,
        fsdp_hint=False,
    )


def smoke() -> ModelConfig:
    return full().replace(name=ARCH_ID + "-smoke", num_layers=2, d_model=128,
                          num_heads=4, num_kv_heads=4, d_ff=256, vocab_size=512)


register_arch(ARCH_ID, full, smoke)
