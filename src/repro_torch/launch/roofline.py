"""Roofline model over the port's dry-run records (port of
`repro/launch/roofline.py`), with the H100's data-sheet constants
(`launch/mesh.py`). Every number it prints is modelled, not measured.

Per (arch x shape) cell on the single-pod mesh, three terms (seconds):

    compute    = FLOPs_per_device / PEAK_FLOPS_BF16     (dry run)
    memory     = modeled_HBM_bytes_per_device / HBM_BW  (analytic, below)
    collective = sum over (kind, axis) of
                 wire_bytes(kind, axis) / link_bw(axis) (dry run)

FLOPs and collective bytes come from the dry run (`launch/dryrun.py`:
the operators each rank runs on its shards, and the operands of the
collectives DTensor issues, by kind and mesh axis). A rank's wire bytes
are its operand bytes times the ring algorithm's factor on the n ranks
of the axis (`WIRE`: an all-gather receives n - 1 operands, a
reduce-scatter sends (n - 1) / n of its operand, an all-reduce twice
that), over the link that axis crosses (`mesh.link_bw`: NVLink inside a
pod, InfiniBand across pods). The dry run's `bytes_accessed` counts every
operator's operands and result unfused, an upper bound on HBM traffic
(reported as `xla_bytes_dev`, the JAX package's name for it). The MEMORY
term is analytic: per device, weight streams (incl. FSDP regathers),
optimizer state, activation traffic (incl. remat recompute), logits,
KV-cache and MoE expert streams — formulas in `_arch_bytes`.

Roofline fraction:
    t_useful = max(MODEL_FLOPS_time, minimal_bytes_time)
    frac     = t_useful / max(compute, memory, collective)
`minimal_bytes` is the mandatory traffic (each param/KV byte touched
once, no regathers, active experts only) — so frac < 1 decomposes into
remat waste, regather waste, cold-expert streaming, dispatch overhead.

The collective term departs from the JAX package's, which divides the
per-rank bytes once more by the chip count (`collective_bytes / (chips *
ICI_BW)`, so that no cell can come out collective-bound); the compute and
memory terms, MODEL/HLO and the cap of frac at 1.0 are JAX's. Each row
also carries t_useful / t_bound before the cap (`ideal_over_bound`),
which the table prints beside the capped fraction.

    python -m repro_torch.launch.roofline [--dir build/dryrun] [--fmt csv]
"""
from __future__ import annotations

import argparse
import dataclasses
import glob
import json
import os
from typing import Dict, List, Optional

from repro_torch.configs import get_config
from repro_torch.configs.shapes import SHAPES
from repro_torch.launch.dryrun import OUT_DIR
from repro_torch.launch.mesh import HBM_BW, PEAK_FLOPS_BF16, link_bw

MSZ = DSZ = 16          # single-pod mesh axes
ACT_C_ATTN = 12.0       # activation r/w per layer (flash-fused + remat)
ACT_C_SSM = 24.0        # mamba: d_in = 2*d_model wide intermediates
# a rank's wire bytes per operand byte, on n ranks (ring algorithms)
WIRE = {"all-gather": lambda n: n - 1,
        "reduce-scatter": lambda n: (n - 1) / n,
        "all-reduce": lambda n: 2 * (n - 1) / n,
        "all-to-all": lambda n: (n - 1) / n,
        "collective-permute": lambda n: 1,
        "broadcast": lambda n: 1}


def model_flops(rec: Dict) -> float:
    n = rec["active_params"]
    d = rec["tokens"]
    return (6.0 if rec["mode"] == "train" else 2.0) * n * d


def _arch_bytes(cfg, shape, chips: int, minimal: bool) -> float:
    """Per-device HBM bytes of one step (modeled or minimal)."""
    spec = SHAPES[shape]
    P = cfg.param_count()
    Pa = cfg.active_param_count()
    L = cfg.num_layers
    D = cfg.d_model
    V = cfg.vocab_size
    T = spec.global_batch * (spec.seq_len if spec.mode != "decode" else 1)
    t_local = T / DSZ                     # batch shards over data only
    n_ssm = sum(1 for b in cfg.blocks if b in ("mamba1", "mamba2"))
    n_attn = L - n_ssm
    act_c = (n_attn * ACT_C_ATTN + n_ssm * ACT_C_SSM) / max(L, 1)
    if minimal:
        act_c /= 3.0                      # no remat recompute, perfect fusion

    # --- weight streams ---
    if spec.mode == "train":
        if minimal:
            w = 2.0 * P / chips * 3       # fwd+bwd+grad, ideally sharded
            opt = 20.0 * P / chips        # m,v fp32 r/w + param update
        else:
            # FSDP regathers: each device reads its model-axis shard of
            # the FULL weights for fwd, again for bwd (remat), grads
            # reduce-scatter r/w
            w = 2.0 * P / MSZ * 3
            opt = 20.0 * P / chips
    elif spec.mode == "prefill":
        # prefill gathers its model-shard of the weights per layer
        w = 2.0 * P / (chips if minimal else MSZ)
        opt = 0.0
    else:
        # decode: the model keeps the 2-D-sharded weight shards local and
        # all-reduces the small [B, 1, *] partial sums, so a device reads
        # its local shard of the weights, not a regathered one
        dense_w = 2.0 * (Pa if minimal else P)
        if cfg.num_experts:
            # the gathered path is exact+profitable only when the step's
            # routed-slot count stays under E (models/transformer.py)
            gate = T * cfg.experts_per_token < cfg.num_experts
            use_gather = getattr(cfg.hades, "expert_gather_decode",
                                 False) and gate
            if minimal and not gate:
                dense_w = 2.0 * P         # all experts genuinely hit
            elif minimal or use_gather:
                dense_w = 2.0 * Pa        # HADES: routed experts only
            else:
                dense_w = 2.0 * P         # dropless streams ALL experts
        w = dense_w / chips
        opt = 0.0

    # --- activations ---
    act = L * t_local * D * 2.0 * act_c
    if minimal:
        act = L * t_local * D * 2.0 * 4.0

    # --- logits ---
    logits = t_local * (V / MSZ) * 4.0 * 2.0
    if minimal:
        logits = t_local * V / chips * 4.0

    # --- attention state (decode KV / prefill KV write) ---
    kv = 0.0
    hd = cfg.resolved_head_dim
    n_kv = cfg.num_kv_heads
    if spec.mode == "decode" and n_attn > 0:
        c_len = min(spec.seq_len, cfg.sliding_window) \
            if cfg.sliding_window else spec.seq_len
        total_kv = n_attn * spec.global_batch * c_len * n_kv * hd * 2 * 2
        if cfg.family == "hybrid":
            total_kv = (L // cfg.shared_attn_every) * spec.global_batch \
                * c_len * n_kv * hd * 2 * 2
        if getattr(cfg.hades, "kv_quant_bits", 16) == 8 and not minimal:
            total_kv *= 0.5625            # int8 + per-block scales
        kv = total_kv / chips             # cache is fully sharded (B, C)
    if cfg.is_encoder_decoder and spec.mode != "decode":
        kv += cfg.encoder_seq_len * spec.global_batch / DSZ * D * 2 * 4

    # --- SSM state (decode) ---
    ssm = 0.0
    if spec.mode == "decode" and n_ssm > 0:
        din = D * cfg.ssm_expand
        ssm = n_ssm * spec.global_batch * din * cfg.ssm_state_dim * 4 * 2
        ssm /= chips if spec.global_batch >= chips else 1

    return w + opt + act + logits + kv + ssm


def collective_seconds(rec: Dict) -> float:
    """The collective term of a dry-run record: each (kind, axis) entry
    of its `collective_axes` ("<kind> over <axis>[+<axis>]"), its operand
    bytes times `WIRE[kind]` on the axis's ranks, over the axis's link."""
    sizes = dict(zip(rec["mesh_axes"], rec["mesh"]))
    t = 0.0
    for label, c in rec["collective_axes"].items():
        kind, axes = label.split(" over ")
        n = 1
        for ax in axes.split("+"):
            n *= sizes[ax]
        t += c["bytes"] * WIRE[kind](n) / link_bw(axes)
    return t


def analyse(rec: Dict) -> Optional[Dict]:
    if "skipped" in rec or "flops" not in rec:
        return None
    chips = rec["chips"]
    cfg = get_config(rec["arch"])
    if rec.get("expert_gather") or rec.get("kv_bits", 16) != 16:
        cfg = dataclasses.replace(cfg, hades=dataclasses.replace(
            cfg.hades,
            expert_gather_decode=bool(rec.get("expert_gather")),
            kv_quant_bits=rec.get("kv_bits", 16)))
    flops_dev = max(rec["flops"], rec.get("flops_rolled", 0.0))
    t_compute = flops_dev / PEAK_FLOPS_BF16
    modeled = _arch_bytes(cfg, rec["shape"], chips, minimal=False)
    minimal = _arch_bytes(cfg, rec["shape"], chips, minimal=True)
    t_memory = modeled / HBM_BW
    t_coll = collective_seconds(rec)
    terms = {"compute": t_compute, "memory": t_memory, "collective": t_coll}
    dominant = max(terms, key=terms.get)
    t_bound = terms[dominant]
    mf = model_flops(rec)
    t_ideal = max(mf / (chips * PEAK_FLOPS_BF16), minimal / HBM_BW)
    return {
        "cell": rec["cell"], "arch": rec["arch"], "shape": rec["shape"],
        "chips": chips, "mode": rec["mode"],
        "compute_s": t_compute, "memory_s": t_memory,
        "collective_s": t_coll, "dominant": dominant,
        "model_flops": mf, "hlo_flops_total": flops_dev * chips,
        "useful_ratio": mf / (flops_dev * chips) if flops_dev else 0.0,
        "xla_bytes_dev": rec.get("bytes_accessed", 0.0),
        "modeled_bytes_dev": modeled, "minimal_bytes_dev": minimal,
        # capped at 1.0, as in the JAX package
        "roofline_frac": min(t_ideal / t_bound, 1.0) if t_bound > 0
        else 0.0,
        "ideal_over_bound": t_ideal / t_bound if t_bound > 0 else 0.0,
    }


def load_all(d: str, mesh: str = "pod256") -> List[Dict]:
    out = []
    for f in sorted(glob.glob(os.path.join(d, f"*_{mesh}.json"))):
        with open(f) as fh:
            rec = json.load(fh)
        a = analyse(rec)
        if a:
            out.append(a)
    return out


def to_markdown(rows: List[Dict]) -> str:
    hdr = ("| cell | compute s | memory s | collective s | dominant | "
           "MODEL/HLO | roofline frac | uncapped |\n"
           "|---|---|---|---|---|---|---|---|")
    lines = [hdr]
    for r in rows:
        lines.append(
            f"| {r['arch']} x {r['shape']} | {r['compute_s']:.3e} | "
            f"{r['memory_s']:.3e} | {r['collective_s']:.3e} | "
            f"**{r['dominant']}** | {r['useful_ratio']:.2f} | "
            f"{r['roofline_frac']:.3f} | {r['ideal_over_bound']:.3f} |")
    return "\n".join(lines)


def to_csv(rows: List[Dict]) -> str:
    cols = ["arch", "shape", "chips", "compute_s", "memory_s",
            "collective_s", "dominant", "useful_ratio", "roofline_frac",
            "ideal_over_bound"]
    lines = [",".join(cols)]
    for r in rows:
        lines.append(",".join(str(r[c]) for c in cols))
    return "\n".join(lines)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--dir", default=OUT_DIR)
    ap.add_argument("--mesh", default="pod256")
    ap.add_argument("--fmt", default="md", choices=("md", "csv"))
    args = ap.parse_args(argv)
    rows = load_all(args.dir, args.mesh)
    print(to_markdown(rows) if args.fmt == "md" else to_csv(rows))
    if rows:
        worst = min(rows, key=lambda r: r["roofline_frac"])
        coll = max(rows, key=lambda r: r["collective_s"])
        print(f"\nworst roofline fraction: {worst['cell']} "
              f"({worst['roofline_frac']:.3f})")
        print(f"most collective-bound:  {coll['cell']} "
              f"({coll['collective_s']:.3e}s)")


if __name__ == "__main__":
    main()
