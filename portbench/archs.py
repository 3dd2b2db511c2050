"""A configuration file (Hugging Face key names, as the source publishes
them) as the program's ``ModelConfig``.

Every size the program runs comes from the file.  Keys whose equation the
program fixes (the multipliers Granite publishes, the norm's epsilon)
must hold the value the program computes with, or the cell refuses to run:
the file states the configuration as it is run.
"""
from __future__ import annotations

import math
from typing import Dict

#: what the program's trunk computes, whatever its configuration says
FIXED = {"rms_norm_eps": 1e-6, "embedding_multiplier": 1.0,
         "residual_multiplier": 1.0, "logits_scaling": 1.0}


def port_config(conf: Dict):
    """The program's ``ModelConfig`` for configuration file ``conf``."""
    from repro_torch.config import MoEConfig, get_model_config

    d, H = int(conf["hidden_size"]), int(conf["num_attention_heads"])
    hd = int(conf.get("head_dim") or d // H)
    for key, value in FIXED.items():
        if key in conf and float(conf[key]) != value:
            raise ValueError(f"{key}={conf[key]}: the program computes "
                             f"with {value}")
    if "attention_multiplier" in conf and not math.isclose(
            float(conf["attention_multiplier"]), 1.0 / math.sqrt(hd)):
        raise ValueError("the program scales attention by 1/sqrt(head_dim)")
    kw = dict(num_layers=int(conf["num_hidden_layers"]), d_model=d,
              num_heads=H, num_kv_heads=int(conf["num_key_value_heads"]),
              head_dim=hd if conf.get("head_dim") else 0,
              vocab_size=int(conf["vocab_size"]),
              window=int(conf.get("sliding_window") or 0),
              rope_theta=float(conf.get("rope_theta", 10000.0)),
              tie_embeddings=bool(conf.get("tie_word_embeddings", False)),
              dtype=conf["torch_dtype"], param_dtype=conf["param_dtype"],
              remat=bool(conf["remat"]))
    if conf.get("num_local_experts"):
        kw.update(d_ff=0, moe=MoEConfig(
            num_experts=int(conf["num_local_experts"]),
            experts_per_token=int(conf["num_experts_per_tok"]),
            d_ff=int(conf["intermediate_size"]),
            capacity_factor=float(conf["expert_capacity_factor"]),
            router_aux_loss=float(conf["router_aux_loss_coef"]),
            router_z_loss=float(conf["router_z_loss_coef"])))
    else:
        kw.update(d_ff=int(conf["intermediate_size"]))
    return get_model_config(conf["arch"]).replace(**kw)
