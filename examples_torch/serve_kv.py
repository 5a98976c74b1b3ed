"""Serving example of the PyTorch port: batched decode through the
HADES-managed paged KV cache — watch the Object Collector demote cold
prefix blocks while generation continues uninterrupted.

    PYTHONPATH=src python examples_torch/serve_kv.py [--device cpu]

Runs on the card (`cuda`, which must exist; each window one CUDA graph
replay) unless `--device` names another device. `main` returns the
server and the generated tokens.
"""
import argparse

import numpy as np
import torch

from repro_torch.models.model import build
from repro_torch.runtime.server import Server, ServerConfig


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda, which must exist)")
    args = ap.parse_args(argv)

    model = build("chatglm3-6b", reduced=True, device=args.device)
    params = model.init(torch.Generator(device=model.device).manual_seed(0))

    srv = Server(model, ServerConfig(batch=4, max_len=96, block_tokens=8,
                                     collect_every=12, backend="proactive"))

    rng = np.random.default_rng(0)
    prompts = rng.integers(0, model.cfg.vocab_size, (4, 6))
    print("decoding 48 tokens for 4 requests...")
    out = srv.generate(params, prompts, max_new=48)
    print(f"generated: {tuple(out.shape)}")
    print(f"KV RSS: {srv.kv_rss_bytes()/2**10:.0f} KiB of "
          f"{srv.kv_cfg.max_objects * srv.kv_cfg.slot_words * 2 / 2**10:.0f} "
          f"KiB allocated")
    print("\ncollector reports (promotion rate / moves / threshold):")
    for i, r in enumerate(srv.reports):
        print(f"  window {i}: promo={r['promotion_rate']:.3f} "
              f"hot+={r['moved_to_hot']:.0f} cold+={r['moved_to_cold']:.0f} "
              f"C_t={r['ciw_threshold']:.0f} rss={r['rss_bytes']/2**10:.0f}KiB")
    return srv, out


if __name__ == "__main__":
    main()
