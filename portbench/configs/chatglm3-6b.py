"""chatglm3-6b (THUDM/chatglm3-6b: 28 layers, hidden 4096, GQA with 2 KV
heads of 128, SwiGLU 13696, vocab 65024) at its published widths and
depth, bf16, served by the port's `Server` from the HADES KV pool
(`configs/chatglm3-6b.json` has the settings). Its plain reference is
`reference/glm.py`."""
from __future__ import annotations

import dataclasses

from portbench.serve_cell import ServeCell

# the published keys and the port's ModelConfig fields they set
FIELDS = {"num_layers": "num_layers", "hidden_size": "d_model",
          "ffn_hidden_size": "d_ff", "num_attention_heads": "num_heads",
          "multi_query_group_num": "num_kv_heads", "kv_channels": "head_dim",
          "padded_vocab_size": "vocab_size", "layernorm_epsilon": "norm_eps"}
# the CPU tests' size: the same family at toy widths
SMALL = {"model": dict(num_layers=2, d_model=64, num_heads=4, num_kv_heads=2,
                       d_ff=128, vocab_size=256, head_dim=16),
         "server": dict(batch=4, max_len=128)}
SMALL_MIX = {"chat": {"requests_per_call": 8,
                      "prompt": {"mean": 14, "sigma": 0.8, "min": 4,
                                 "max": 40},
                      "output": {"mean": 10, "sigma": 0.7, "min": 2,
                                 "max": 24}}}
# the control's CPU test: deep and wide enough, and enough served tokens,
# for the fp8 control's gap to pass the cell's limit as at full size
CONTROL = {"model": dict(num_layers=8, d_model=256, num_heads=8,
                         num_kv_heads=2, d_ff=768, vocab_size=4096,
                         head_dim=32),
           "server": dict(batch=4, max_len=128),
           "mix": {"requests_per_call": 8,
                   "prompt": {"mean": 21, "sigma": 0.8, "min": 4,
                              "max": 48},
                   "output": {"mean": 28, "sigma": 0.7, "min": 8,
                              "max": 48}}}


def make(spec, mix, seed, device, small=None) -> ServeCell:
    from repro_torch.configs import get_config
    cfg = get_config(spec["served_as"]["port_arch"])
    for key, field in FIELDS.items():
        if getattr(cfg, field) != spec["published"][key]:
            raise ValueError(f"{key}: the port serves {getattr(cfg, field)}, "
                             f"the file says {spec['published'][key]}")
    if cfg.dtype != spec["served_as"]["dtype"]:
        raise ValueError(f"the port serves {cfg.dtype}")
    if small:
        cfg = dataclasses.replace(cfg, **small["model"])
        spec = dict(spec, server=dict(spec["server"], **small["server"]))
    return ServeCell(spec, mix, seed, device, model_cfg=cfg,
                     check=spec["check"])
