#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py [--access-scan-was PATH] [--migrate-was PATH]
                          [--engine-only | --hybrid-only | --train-only |
                           --crest-only | --families-only]
    python3 -m torch.distributed.run --standalone --nproc-per-node 4 \
        chip_smoke.py --dist-only [--device cpu]

Run from the root of a checkout (it puts `src` on sys.path itself). With
--access-scan-was, phase 3 also builds an earlier `access_scan.cu` (its C
entry without the scratch argument) and checks and times it beside the
kernel; --migrate-was does the same for an earlier `migrate.cu` (its C
entry without the work and scratch arguments) in phases 3 and 10.
--engine-only runs phases 1, 2 and 10 alone, --hybrid-only phases 1, 2,
phase 3's flash_attention and mamba_scan checks and phase 11, --train-only
phases 1, 2, phase 3's mamba_scan checks and phase 12, --crest-only
phases 1, 2 and 13, --families-only phases 1, 2, phase 3's
flash_attention checks and phase 14; none prints a result line. In order:

  1. the card: name, count, and nvidia-smi's name and power limit;
  2. build: every CUDA kernel of the port (`src/repro_torch/kernels/
     csrc/*.cu`) with nvcc for sm_90a, one nvcc per source, in parallel;
     ptxas's register / shared-memory / spill lines are printed;
  3. each kernel against its plain PyTorch version on the card, at the
     shapes its path gives it and at the CPU tests' shapes (access_scan
     and migrate exactly, each also at olmoe-1b-7b's pool: its 16-layer
     object table and its 128 KiB rows, at the collector's shape, migrate
     on three lists there, "hazard" (cold movers land in the slots hot
     movers vacate), "disjoint" (no destination is a source) and "swap"
     (hot and cold movers trade slots), each
     with the shares of its live moves that the kernel stages and copies
     late (`ref.migrate_phased`), one device operation a call and one
     cooperative kernel node when captured in a CUDA graph;
     paged_attention and flash_attention within 2e-2 in bf16 and 2e-5 in
     fp32, paged_attention's access bits exactly,
     mamba_scan bit for bit in fp32 and bf16 inputs (also at zamba2's
     mamba2 chunk carry: B=2 x 32 chunks and B=8 x 1 over 64 x 5120
     lanes), and its backward kernel mamba_scan_bwd bit for bit against
     `ref.mamba_scan_bwd` at the sweep's shapes, falcon-mamba's prefill
     shape and zamba2's carry; flash_attention at chatglm3-6b's, olmoe-1b-7b's,
     zamba2-2.7b's (H = KV = 32, D = 80), seamless-m4t-large-v2's
     (its encoder non-causal over 1024 frames, its decoder; H = KV = 16,
     D = 64) and qwen2-vl-72b's (H = 64 over KV = 8, D = 128) prefill
     shapes, each timed beside SDPA and its bound, and
     at the bf16 edges of its tensor-core variant and on strided views,
     each case logged with the variant that ran: bf16 on the tensor
     cores, fp32 and a view TMA cannot describe on the CUDA cores;
     paged_attention at the serve shape, at granite's decode shape
     (B=8 H=48 KV=1 D=128: REP 48, several blocks per KV head) and at
     olmoe-1b-7b's (B=8 H=16 KV=16 D=128: REP 1) with random
     lengths, at full length and with edge lanes (length 0, a -1 hole
     inside the length, a slot >= n_slots), and at REP 1-48 x D 16-256 x
     bt 4-16, each case logged with the variant of its split kernel: bf16
     on the tensor cores at every REP; access_scan also at n % 4 != 0, on
     a table view off 16-byte alignment and at 2^20 words over 65536
     superblocks), then timed beside its plain version, a one-call
     PyTorch yardstick where one exists, and the least time the card
     could take (bound_ms), at the shape of its path: per call over
     back-to-back calls with CUDA events (`ms`, `plain_ms`, `library_ms`)
     and as device time from a torch.profiler trace (`device_ms`, ...).
     paged_attention is timed at granite's shape too and must take no
     more device time there than SDPA; a profiled access_scan call must
     be exactly one device operation (no memset), with the device
     operations per call counted at the serve shape and, with L2 evicted
     before each call, at 2^20 words, against the bound;
  4. the serving path: `Server.serve` with chatglm3-6b at its full
     published width and depth (28 layers, random bf16 weights from a
     seeded generator), 8 lanes, max_len 512, 16-token blocks, 16 greedy
     requests, in graph mode, the default on the card: a warm-up request
     captures the serve window's CUDA graph, and every window of the
     counted run must be one replay of it. Every kernel's launch count is
     reset just before and read just after (a replay adds the launches its
     capture recorded), and the run must complete every request, launch
     each of the three HADES kernels (and flash_attention never), run
     every paged_attention launch on its tensor-core variant, migrate rows
     and end with KV RSS 0. CUDA's sync debug mode counts the
     synchronising operations of the run: none may fall inside a window
     and exactly one at each window's close. The same requests are then
     served in eager mode (op by op, the server's private `_eager`) under
     the same gates: the greedy tokens and the final pool metadata must be
     identical to the graph run's, and both walls are printed; since
     the eager run is host-bound, its wall proportional to the layers,
     this comparison runs on a second server over the model's first
     EAGER_LAYERS = 4 layers (the same weights), graph run then eager
     run;
  5. where the serve time goes, for each mode: the same requests served
     again with torch.profiler on for two windows in mid-run; the
     device's busy and idle share of those windows' unprofiled wall time
     (from phase 4), kernels per step, host syncs, copies and memsets per
     window, and each HADES kernel's device time per launch
     (paged_attention: one split and one combine kernel per layer and
     step, timed together, and counted: 448 of each; access_scan: its one
     kernel); in eager mode (at 4 layers) also the device time, copies
     and memsets per step by the port function and host op that launched
     them;
  6. the kernel path against the plain path on the card at 2 layers and
     full width: a teacher-forced serve window (pool metadata exactly,
     logits within 5e-2), the kernel path a replay of the window's graph
     and the plain path op by op; a prefill of B=2 x S=4096 with
     attn_impl="flash" against "blockwise" on the same weights (float32
     logits within 5e-2; bfloat16 logits within two bf16 ulps of the
     largest logit, see `prefill_flash_vs_blockwise`); and falcon-mamba's
     prefill of B=2 x S=4096 with the mamba_scan kernel against the same
     call with its plain version patched in, in float32 and bfloat16 (the
     kernel-vs-plain gap no larger than the gap between two kernel runs),
     and its float32 teacher-forced decode of B=2 x 64 tokens against the
     prefill of the same tokens (logits within 1e-3);
  7. the prefill path: `Model.prefill` with chatglm3-6b at full width and
     depth (attn_impl="flash", random bf16 weights from a seeded
     generator) on B=2 prompts of S=4096 tokens; the launch counts are
     reset just before the first prefill and read just after it: exactly
     28 flash_attention launches (one per layer), all of the tensor-core
     variant, and no other kernel; the logits [2, 4096, 65024] fp32 must
     be finite. The profiled prefill must show 28 kernels named
     flash_attention_wgmma_kernel and none of the CUDA-core
     flash_attention_kernel. Then ms per prefill and prefill tokens/s
     (median of 3), the idle share and flash_attention's share of the
     device time in one profiled prefill, and the peak device memory (idle
     shares are read against the profiled run's own wall);
  8. the mamba1 path: falcon-mamba-7b at full width and depth (64 mamba1
     layers, random bf16 weights from a seeded generator). `Model.prefill`
     on B=2 x S=4096 tokens: exactly 64 mamba_scan launches and no other
     kernel, finite logits [2, 4096, 65024]; ms per prefill and tokens/s
     (median of 3), the idle share, mamba_scan's share of the device time,
     the top kernels and kernels per prefill from one profiled prefill,
     and the peak device memory. Then decode of 8 sequences through
     `decode_step` (32 teacher-forced prompt tokens, 32 greedy tokens):
     exactly 64 mamba_scan launches per step, ms per step, tokens/s and the
     idle share of a profiled stretch; and the bf16 drift between the
     prefill and the teacher-forced decode of B=2 x 64 tokens (reported);
  9. the MoE path: (a) phases 4 and 5 again with olmoe-1b-7b at its full
     published width and depth (16 layers, d_model 2048, 16 heads over 16
     KV heads, 64 experts top-8, expert d_ff 1024, vocab 50304, random
     bf16 weights from a seeded generator), under the same gates, with 16
     paged_attention launches per model step and a per-expert capacity
     at the 8 lanes that drops no decode token; (b) phase 7 with
     olmoe-1b-7b: exactly 16 flash_attention launches a prefill, all on
     the tensor cores; (c) phase 6's comparisons at full width and 2
     layers: a teacher-forced serve window of olmoe-1b-7b and of
     mixtral-8x7b (the kernel path a replay, the plain path op by op),
     and olmoe's prefill with flash against blockwise. Top-k routing is
     discontinuous, so a bf16 rounding difference can send a token whose
     k-th and (k+1)-th gates nearly tie to another expert: each MoE
     comparison runs free (the routing flips and the gate gaps at them
     printed, pool metadata still exact, no flip whose router input
     differs by rounding only at a gate gap over 1e-3) and with the
     kernel path's expert choices pinned to the plain path's, which is
     gated (in the serve window within 5e-2 plus the rounding floor, the
     distance of a plain path with float64 attention from the plain path,
     with whether it holds 5e-2 reported; phase 6's rule in the prefill);
 10. the object engine: `make_config(699050, 256, sb_slots=64,
     page_slots=4, slack=1.5)`, 2^20 slots of 1 KiB (the most a table
     word's 20-bit slot field addresses), `EngineOptions(collect_every=20,
     backend=proactive, move_budget=16384)`. access_scan and migrate are
     held exactly against their plain versions at the engine's shapes and
     timed (migrate on the hazard, disjoint and swap lists, and on the
     disjoint one no slower in device time than data[dst] = data[src]);
     the full run does this at the end of phase 3, before the long phases
     (the profiler lost records when it came later). (a) every object
     allocated through `Engine.step` with payloads from a seeded
     generator, then the load phase's reset;
     (b) 64 windows of YCSB-B (19 read steps and 1 write step of 4096
     scrambled-Zipf keys over the first third of the ranks) through
     `make_trace` and `Engine.run_window` in graph mode: every window after
     the first one replay of one graph, access_scan and migrate launched
     once a window (counted through the replays), no synchronising CUDA
     operation inside a window, rows moved both ways; (c) the same windows
     op by op through `Hades` from a clone of the loaded pool: state, read
     outputs and reports identical to (b)'s, Page Utilization before
     listed windows' closing op; (d) the first 8 windows with both kernels
     patched to their plain versions: the state identical to (b)'s; every
     object read back against a numpy mirror of its last payload; (e) ms a
     window and ops/s in both modes, moves per window, the heap histogram,
     RSS / host bytes, and from 4 profiled windows of (b) the device's
     busy and idle share, kernels a window and each kernel's device time a
     launch against its bound; (f) `SimHeap` over the same objects and the
     first 16 windows' keys with its backend on the card and on the CPU:
     identical window logs and page arrays;
 11. the hybrid path: zamba2-2.7b at full width and depth (54 blocks: 9
     groups of 5 mamba2 blocks and one shared attention block, d_model
     2560, 32 heads of 80 over 32 KV heads, N 64, vocab 32000, random bf16
     weights from a seeded generator), attn_impl="flash": (a)
     `Model.prefill` on B=2 x S=4096 with exactly 9 flash_attention
     launches (all on the tensor cores, 9 `flash_attention_wgmma_kernel`
     and 45 `mamba_scan_kernel` in the profiled prefill), 45 mamba_scan
     launches and no other kernel, finite logits [2, 4096, 32000], and
     phase 8's measurements; (b) decode of 8 sequences as in phase 8, 45
     mamba_scan launches and no flash_attention a step, and the bf16
     drift; (c) at full width and 12 layers (two groups) the flash prefill
     against blockwise in float32 and bfloat16 (phase 6's rule), and the
     prefill with mamba_scan's plain version patched in (phase 6's rule),
     with the float32 decode of B=2 x 64 tokens against their prefill
     within 1e-3;
 12. training, under deterministic algorithms where bits are compared:
     (a) zamba2-2.7b at full width and depth (bf16, remat="full" per
     group, attn_impl="blockwise", AdamW as `launch/train.py` builds it),
     six steps of `Trainer.run` on B=2 x S=4096 tokens of
     `TokenPipeline(seed=0)` (B=1 if B=2 does not fit, the cut listed):
     every loss and grad norm finite, exactly 90 mamba_scan launches (45
     forward, 45 recompute) and 45 mamba_scan_bwd a step and no other
     kernel; ms a step, train tok/s, peak memory, and one profiled step
     (idle share, both kernels' records, device time by where it comes
     from); (b) zamba2-2.7b at full width and 12 layers in float32: every
     gradient through the kernels bit for bit the one with the plain
     scan patched in; (c) chatglm3-6b at full width and 4 layers, bf16,
     B=2 x S=2048: the gradients under remat "none", "full" and "dots"
     bit for bit equal, then three Trainer steps with finite losses; (d)
     zamba2-2.7b reduced: a run resumed from step 3's checkpoint replays
     steps 4-6 bit for bit (losses, params, optimizer state);
 13. the paper's evaluation substrate, no kernel of its own: CrestKV over
     SimHeap (placement on the host in numpy, the backend step on the card)
     with the seeded data of the paper's benchmark scripts. (a) Table 1:
     each of the ten structures at 60,000 keys under YCSB-A (12 ops a key,
     a window of 3 x keys), as the baseline (`null`, no tidying) and as
     HADES (`proactive`), each with the backend on the card and on the CPU:
     identical runs (window logs, run statistics, value ids, the heap's
     placement and page arrays); page-utilization gain, memory reduction
     and overhead per structure; (b) fig 7: hash-pugh at 40,000 keys under
     YCSB-C (60 ops a key), the free run and the six systems under a target
     of 40 % of its footprint: every op counted, page utilization in (0, 1]
     in every window; RSS share, slowdown and faults per system; (c)
     hash-pugh under YCSB-C with `proactive` at the paper's 10 M keys, 40 M
     ops in windows of 10 M: every op counted, live addresses inside their
     heaps and disjoint, page utilization in (0, 1] and RSS within the
     heaps' footprint in every window; load and window seconds,
     backend_step's device ms, pages, RSS, the process's peak RSS; (d) the
     tiered embedding at zamba2-2.7b's width (vocab 32000 x 2560 bf16, 4096
     hot rows): 16 windows of `lookup` of B=2 x S=4096 `TokenPipeline`
     tokens and `collect`, then `write_rows` of 64 rows, half hot,
     identical on the card and the CPU; cold-hit rate and coverage per
     window, ms per call, and bench_embedding.py's steady cold-hit rates at
     hot fractions 0.01, 0.05 and 0.25;
 14. the encoder-decoder and VLM families (random bf16 weights from a
     seeded generator, attn_impl="flash"): (a) seamless-m4t-large-v2 at
     full width and depth (24 encoder + 24 decoder layers, d_model 1024,
     16 heads of 64, d_ff 8192 gated, vocab 256206): phase 7's prefill of
     B=2 x S=4096 tokens over 1024 frame embeddings fp32, exactly 48
     flash_attention launches a prefill, all on the tensor cores (24
     non-causal in the encoder, 24 causal in the decoder, counted by
     mask), finite logits, ms a prefill and the idle share; then 8
     teacher-forced and 8 greedy decode steps of 8 sequences over the
     encoder's output of their own frames: ms a step, kernels a step,
     idle share; (b) qwen2-vl-72b at full width and its first 16 of 80
     layers (80 are 135 GiB of bf16, past the card; d_model 8192, 64
     heads over 8 KV heads, d_ff 29568, vocab 152064): phase 7's prefill
     of 256 patch embeddings and 3840 tokens (S = 4096), exactly 16
     flash_attention launches, all on the tensor cores; the same prefill
     through `lm_forward` with M-RoPE grid positions [3, B, S]; 16 decode
     steps of 8 sequences; (c) both at full width and 2 layers (2 + 2 for
     seamless), phase 6's rule: flash against blockwise in float32 and
     bfloat16, the prefill with flash_attention's plain version patched
     in (qwen2-vl also with the grid positions, where blockwise masks by
     the temporal stream and is no reference), and the float32
     teacher-forced decode of B=2 x 64 tokens against their prefill
     within 1e-3 of the largest |logit|;
 15. the distributed layer (`launch/mesh.py`, `launch/shardings.py`,
     `optim/compression.py`, `ckpt.restore(shardings=)`; no kernel of its
     own) on a world-1 NCCL group and its (1, 1) host mesh: (a)
     `compress_int8` / `decompress_int8` on the card equal the CPU bit for
     bit at sizes that are and are not multiples of the 256-element block
     (one block of zeros), `compressed_allreduce` over the mesh's data
     axis returns the local decompression and the residual; (b)
     qwen2-vl-72b at full width and 2 layers in fp32 (TF32 off),
     blockwise attention: the prefill of params, patches, tokens and
     [3, B, S] grid positions laid out as DTensors by the sharding rules
     equals the plain-tensor prefill bit for bit (B=2 x S=4096), and so
     does the bf16 prefill through flash_attention (the kernel on the
     local tensors, 2 launches, on the tensor cores); (c) that
     model in bf16 saved whole and restored with its param specs: every
     leaf equal, laid out by its spec.

--dist-only runs on four cards, one process each, under `python3 -m
torch.distributed.run --standalone --nproc-per-node 4` (the environment
gives ranks and rendezvous), builds only the kernel its path runs and
prints on rank 0 only:
(a) phase 15 (a) over the 4-rank data axis of a (4, 1) mesh (ones sum to
exactly 4, seeded grads to the sum of the four decompressions within 4
fp32 ulps); (b) phase 15 (b) on the (2, 2) ("data", "model") mesh, held
within 1e-4 of the largest |logit| to the one-card prefill, then 4
teacher-forced decode steps with the state laid out by
`decode_state_shardings` (the cache length over "model"); the same
2-layer prefill through flash_attention on each card's batch and head
shard against one card's flash prefill, in fp32 within 1e-4 (the CUDA
cores) and in bf16 within DIST_BF16_TOL (every launch on the tensor
cores); (c) qwen2-vl-72b at all 80 layers in bf16, every matrix split
over both axes of the (2, 2) mesh (DTensor all-reduces partial sums of
activations; it does not gather the weights),
drawn leaf by leaf on every rank from a generator seeded 0, each rank
keeping its shard: a B=2 x S=4096 prefill (256 patches, 3840 tokens, grid
positions) through flash_attention (one launch a layer on each card, on
its batch and head shard, all on the tensor cores; rank 0 builds the two
flash sources before (b)'s flash checks),
4 decode steps from an empty cache, finite logits; ms a
prefill, tok/s, ms a decode step, each card's peak memory, the
collectives of a prefill and of a decode step by kind and bytes, and one
more prefill profiled on each card (busy share, device ms in NCCL
kernels, GEMMs and the rest). With
--device cpu it rehearses on the CPU with gloo at the reduced config.
Its numbers go to build/chip_smoke_dist.json.

It exits non-zero, with no result line, if there is no CUDA device, if it
is not run from a checkout, or if any phase fails. The last lines of its
output are nvidia-smi's name/power line, a JSON line with every kernel's
numbers, and {"ok": true, "device": {...}}. The numbers also go to
build/chip_smoke.json.
"""
import collections
import contextlib
import json
import os
import subprocess
import sys
import time
import warnings
from pathlib import Path
from unittest import mock

import numpy as np

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

SERVE = dict(batch=8, max_len=512, block_tokens=16, collect_every=8)
N_REQUESTS, MAX_NEW = 16, 32
PREFILL_B, PREFILL_S = 2, 4096   # cut from prefill_32k (B=32, S=32768)
DECODE_B, DECODE_PROMPT, DECODE_NEW = 8, 32, 32   # falcon-mamba decode
DRIFT_S = 64       # tokens of the prefill-vs-decode comparisons
SSD_CHUNK = 128    # mamba2_forward's chunk: the carry runs over S / 128
TRACE_FROM = 6     # first of the two traced serve windows; lanes are full
# the depth of the eager serve runs (phases 4-5, 9(a)), against the graph
# run at the same depth: op by op a step is host-bound, ~12 ms a layer
EAGER_LAYERS = 4
PROFILES = 3       # traces taken at most when one comes back short (`measure_prefill`, `device_ops`)
# the widest k-th to (k+1)-th gate gap at which the two paths' bf16 rounding
# may flip a top-k choice whose router input differs by rounding only: the
# flips measured on an H100 at olmoe's and mixtral's full width lay at gaps
# of 9e-6 to 6.9e-4, against median gaps of 1.8e-3 and 4.6e-2
ROUTING_TIE_GAP = 1e-3
# kernel names in the profiler's trace; the first name's launches count
HADES_KERNELS = {"paged_attention": ("paged_attention_split",
                                     "paged_attention_combine_kernel"),
                 "access_scan": ("access_scan_kernel",),
                 "migrate": ("migrate_kernel",)}
# the source of a kernel that shares another's file
KERNEL_SOURCE = {"mamba_scan_bwd": "mamba_scan"}
TPU_KERNEL = {
    "paged_attention": "src/repro/kernels/paged_attention.py:74",
    "access_scan": "src/repro/kernels/access_scan.py:88",
    "migrate": "src/repro/kernels/migrate.py:38",
    "flash_attention": "src/repro/kernels/flash_attention.py:65",
    "mamba_scan": "src/repro/kernels/mamba_scan.py:44",
    "mamba_scan_bwd": "src/repro/kernels/mamba_scan.py:44",
}
FLASH_SOURCES = {
    "tensor_cores": "src/repro_torch/kernels/csrc/flash_attention_wgmma.cu",
    "cuda_cores": "src/repro_torch/kernels/csrc/flash_attention.cu"}
LIBRARY = {
    "paged_attention": "torch.nn.functional.scaled_dot_product_attention",
    "migrate": "data[dst] = data[src]", "access_scan": None,
    "flash_attention": "torch.nn.functional.scaled_dot_product_attention("
                       "is_causal=True, enable_gqa=True)",
    "mamba_scan": None, "mamba_scan_bwd": None}


def log(*a):
    """Print (only on rank 0 of a `torch.distributed.run` launch)."""
    if os.environ.get("RANK", "0") == "0":
        print(*a, flush=True)


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()
    return out[0]


def cards() -> list:
    """Every card's index, name, power limit and draw, SM clock and
    temperature, as nvidia-smi reads them now."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=index,name,power.limit,power.draw,"
         "clocks.sm,temperature.gpu", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
        check=True).stdout.strip().splitlines()


def cuda_time(fn, iters: int, warmup: int = 3) -> float:
    """Mean ms of fn() over `iters` launches, CUDA events, after warm-up."""
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    stop.record()
    stop.synchronize()
    return start.elapsed_time(stop) / iters


def timings(fn, iters: int, plain, plain_iters: int, library=None) -> dict:
    """The kernel's, its plain version's and the library call's time per
    call: CUDA events over back-to-back calls and profiler device time
    (with the kernel's device operations per call in that trace)."""
    device_ms, n_ops, _ = device_ops(fn, iters)
    out = dict(ms=cuda_time(fn, iters), device_ms=device_ms,
               device_ops=n_ops, plain_ms=cuda_time(plain, plain_iters),
               plain_device_ms=device_ops(plain, plain_iters)[0],
               library_ms=None, library_device_ms=None)
    if library is not None:
        out.update(library_ms=cuda_time(library, iters),
                   library_device_ms=device_ops(library, iters)[0])
    return out


def _fmt(t: dict) -> str:
    lib = (f", library {t['library_ms']:.4f} / {t['library_device_ms']:.4f}"
           if t["library_ms"] is not None else "")
    return (f"{t['ms']:.4f} ms per call / {t['device_ms']:.4f} ms device "
            f"(plain {t['plain_ms']:.4f} / {t['plain_device_ms']:.4f}{lib})")


def bound(bytes_moved: float, ops: float, kind: str):
    """The least time (ms) of the work on the card, and what bounds it:
    the H100's data-sheet HBM rate and peak op rates (`launch/mesh.py`)."""
    from repro_torch.launch.mesh import HBM_BW, PEAK_OPS
    t_bytes = bytes_moved / HBM_BW * 1e3
    t_ops = ops / PEAK_OPS[kind] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


# ---------------------------------------------------------------------------
# phase 3: kernels against their plain versions
# ---------------------------------------------------------------------------
def _random_table(g, n, n_slots, dev):
    import torch
    from repro_torch.core import object_table as ot
    f = [torch.randint(0, hi, (n,), generator=g, dtype=torch.int32)
         for hi in (n_slots + 5, 4, 2, 3, 32)]
    return ot.pack(*f).to(dev)


SCAN_POOL = (1 << 20, 16, 65536)   # 16 GiB of 16 KiB objects: words,
                                   # slots per superblock, superblocks
L2_FLUSH_BYTES = 256 << 20         # five times the H100's 50 MB L2


_CUPTI = []
# torch.cuda._sleep's spin kernels that bracket a profiled range: OPEN_PAD
# short ones of PAD_CYCLES, then one of MARK_CYCLES, open it; one of
# MARK_CYCLES closes it (`open_trace`, `close_trace`, `trace_events`)
SENTINEL = "spin_kernel"
OPEN_PAD, PAD_CYCLES, MARK_CYCLES = 256, 1000, 200000
MARK_US = 20.0     # a spin this long is a mark (~100 us on an H100)


def open_trace():
    """Launches the spin kernels that open a profiled range: call it just
    after the profiler starts (see `trace_events`)."""
    import torch
    for _ in range(OPEN_PAD):
        torch.cuda._sleep(PAD_CYCLES)
    time.sleep(0.002)
    torch.cuda._sleep(MARK_CYCLES)


def close_trace():
    """Launches the spin kernel that closes a profiled range, then
    `flush_device_records()`: call it last before the profiler stops."""
    import torch
    torch.cuda._sleep(MARK_CYCLES)
    flush_device_records()


def trace_events(prof):
    """(prof's events without the spin kernels, whether the trace is
    whole). On the H100, torch.profiler loses the first records of some
    traces: from a few to hundreds, or all of them, anywhere in a run
    (tools/profiler_loss_probe.py measures it). The short spin kernels of
    `open_trace` take the place of the profiled work at the head of the
    trace; a trace counts as whole only when the mark after them and the
    one that closes the range are both in it, and a trace that is not
    whole is taken again."""
    events = prof.events()
    marks = sum(SENTINEL in e.name and e.time_range.elapsed_us() > MARK_US
                for e in events)
    return [e for e in events if SENTINEL not in e.name], marks == 2


def flush_device_records():
    """Synchronizes, then has CUPTI hand every device record it still holds
    to the profiler (cuptiActivityFlushAll, forced); `close_trace` calls
    it. On the H100, traces of several CUDA graph replays ended without the
    tail of the last replay, its closing device-to-host copy included, more
    often when the profiler was stopped without it; it does not stop every
    loss (`trace_events`). The library is the one the process has loaded
    (torch's), found in /proc/self/maps."""
    import ctypes
    import torch
    torch.cuda.synchronize()
    if not _CUPTI:
        with open("/proc/self/maps") as f:
            paths = {line.split(None, 5)[5].strip() for line in f
                     if "libcupti" in line and len(line.split(None, 5)) == 6}
        if len(paths) != 1:
            raise RuntimeError(f"want one loaded libcupti, found {paths}")
        _CUPTI.append(ctypes.CDLL(paths.pop()))
    rc = _CUPTI[0].cuptiActivityFlushAll(1)   # CUPTI_ACTIVITY_FLAG_FLUSH_FORCED
    if rc != 0:
        raise RuntimeError(f"cuptiActivityFlushAll returned {rc}")


def device_ops(fn, iters: int, between=None):
    """(device ms, device operations, their names) per call of fn(): the
    summed durations of every kernel, memset and copy in a torch.profiler
    trace of `iters` calls after one warm-up call, each call after
    between() when given; between()'s own device operations (named from a
    trace of it alone) are left out. A trace that is not whole
    (`trace_events`), or whose record count is not a whole multiple of
    `iters`, lost records (torch.profiler's record loss of §7 of PERF.md)
    and is taken again, up to PROFILES traces;
    the fullest is kept (logged when none is whole), and it fails if every
    one is empty."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    cuda_t = torch.autograd.DeviceType.CUDA

    def trace(f, n):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            open_trace()
            for _ in range(n):
                f()
            close_trace()
        events, ok = trace_events(prof)
        return [e for e in events if e.device_type == cuda_t], ok
    skip = set()
    if between is not None:
        between()
        for _ in range(PROFILES):
            got, ok = trace(between, 1)
            if ok:
                break
        skip = {e.name for e in got}
    fn()
    torch.cuda.synchronize()

    def step():
        if between is not None:
            between()
        fn()
    dev = []
    for attempt in range(1, PROFILES + 1):
        got, ok = trace(step, iters)
        got = [e for e in got if e.name not in skip]
        dev = max(dev, got, key=len)
        if ok and got and len(got) % iters == 0:
            break
        log(f"device_ops: trace {attempt} of at most {PROFILES} recorded "
            f"{len(got)} device operations in {iters} calls"
            + ("" if ok else ", and lost spin kernels of its own"))
    if not dev:
        raise AssertionError("the profiler recorded no device activity")
    return (sum(e.time_range.elapsed_us() for e in dev) / 1e3 / iters,
            len(dev) / iters, sorted({e.name[:60] for e in dev}))


def _scan_was(path):
    """access_scan(...) of an earlier access_scan.cu (its C entry without
    the scratch: two memsets and the kernel), built from `path` with the
    port's nvcc flags into build/; for comparing in one run."""
    import ctypes
    import torch
    from repro_torch.kernels import build, ops
    out = ROOT / "build" / "was" / "access_scan.so"
    out.parent.mkdir(parents=True, exist_ok=True)
    subprocess.run([build.nvcc(), *build.NVCC_FLAGS, "-o", str(out),
                    str(path)], check=True, capture_output=True, timeout=600)
    lib = ctypes.CDLL(str(out))
    P, I = ctypes.c_void_p, ctypes.c_int
    lib.access_scan.argtypes = (P,) * 7 + (I,) * 5 + (P,)
    lib.access_scan.restype = I

    def call(table, ct, *, sb_slots, n_sbs, with_hist):
        # the earlier wrapper's checks and its five outputs, so that its
        # host cost compares with the wrapper's (it counts no launch)
        ops._on_cpu(table, ct)
        ops._check(table.dim() == 1 and table.dtype == torch.int32
                   and table.is_contiguous(), "table: [N] int32 contiguous")
        ops._check(ct.dtype == torch.float32 and ct.numel() == 1,
                   "ciw_threshold: one float32")
        ops._check(sb_slots > 0 and n_sbs >= 0, "sb_slots > 0, n_sbs >= 0")
        n, dev = table.shape[0], table.device
        outs = (torch.empty_like(table), torch.empty(n, dtype=torch.bool,
                                                     device=dev),
                torch.empty(n, dtype=torch.bool, device=dev),
                torch.empty(n_sbs, dtype=torch.int32, device=dev),
                torch.empty((), dtype=torch.int32, device=dev))
        rc = lib.access_scan(table.data_ptr(), ct.data_ptr(),
                             *(x.data_ptr() for x in outs), n, sb_slots,
                             n_sbs, int(with_hist), ops._n_sms(dev),
                             ops._stream())
        if rc:
            raise RuntimeError(f"the earlier access_scan failed: {rc}")
        return outs
    return call


def check_access_scan(dev, pcfg, olmoe_pcfg, was_source=None):
    """Exact against the plain version at the serve shape, olmoe-1b-7b's
    serve table (`olmoe_pcfg`), the CPU tests' shapes, n % 4 != 0, a table view off 16-byte alignment (the scalar
    pass) and 2^20 words over 65536 superblocks (`SCAN_POOL`: bins past
    shared memory), each with and without the histogram. A profiled call
    at the serve shape must be exactly one device operation, the kernel
    (no memset). Timed at the serve shape (with_hist=False, the serve
    path's call) beside the plain version, and with the histogram; at
    SCAN_POOL with L2 evicted before each call, with and without the
    histogram, against the bound. With `was_source` (an earlier
    access_scan.cu), that kernel is checked and timed at the same shapes
    in the same run."""
    import torch
    from repro_torch.kernels import ops, ref
    g = torch.Generator().manual_seed(1)
    ct = torch.tensor(2.0, device=dev)
    serve = (pcfg.max_objects, pcfg.sb_slots, pcfg.n_sbs)
    olmoe = (olmoe_pcfg.max_objects, olmoe_pcfg.sb_slots, olmoe_pcfg.n_sbs)
    shapes = [serve, olmoe, (128, 8, 16), (300, 16, 64), (1027, 8, 100),
              SCAN_POOL]
    tables = {}
    for n, sb, nsb in shapes + [(1001, 16, 64)]:
        table = _random_table(g, n, sb * nsb, dev)
        if n == 1001:   # 4 bytes past a 16-byte boundary
            table = table[1:]
        tables[(n, sb, nsb)] = table
    was = _scan_was(was_source) if was_source else None
    impls = {"kernel": ops.access_scan}
    if was:
        impls["was"] = was
    for (n, sb, nsb), table in tables.items():
        for with_hist in (False, True):
            kw = dict(sb_slots=sb, n_sbs=nsb, with_hist=with_hist)
            want = ref.access_scan(table, ct, **kw)
            for name, fn in impls.items():
                got = fn(table, ct, **kw)
                torch.cuda.synchronize()
                if not all(map(torch.equal, got, want)):
                    raise AssertionError(f"access_scan ({name}) differs at "
                                         f"n={n} with_hist={with_hist}")
    table = tables[serve]
    per = {}
    for name, fn in impls.items():
        for with_hist in (False, True):
            kw = dict(sb_slots=serve[1], n_sbs=serve[2], with_hist=with_hist)
            call = (lambda f=fn, k=kw: f(table, ct, **k))
            # operations counted in a short trace (a long one may drop
            # events), time from a long one
            _, n_ops, names = device_ops(call, 10)
            per[(name, "serve", with_hist)] = dict(
                device_ms=device_ops(call, 100)[0], device_ops=n_ops,
                names=names)
    one = [per[("kernel", "serve", h)] for h in (False, True)]
    if any(o["device_ops"] != 1 or any("Memset" in x for x in o["names"])
           for o in one):
        raise AssertionError(f"access_scan is not one device operation a "
                             f"call: {one}")
    kw = dict(sb_slots=serve[1], n_sbs=serve[2], with_hist=False)
    t = timings(lambda: ops.access_scan(table, ct, **kw), 200,
                lambda: ref.access_scan(table, ct, **kw), 50)
    if was:
        t["was_ms"] = cuda_time(lambda: was(table, ct, **kw), 200)
    n = serve[0]
    b_ms, b_by = bound(n * (4 + 4 + 1 + 1) + 4 * serve[2] + 8, 20 * n,
                       "int32")
    flush_buf = torch.empty(L2_FLUSH_BYTES // 4, dtype=torch.int32,
                            device=dev)

    def flush():
        flush_buf.fill_(1)
    big = tables[SCAN_POOL]
    n_big, sb_big, nsb_big = SCAN_POOL
    pool_bound = bound(n_big * 10 + 4 * nsb_big + 8, 20 * n_big, "int32")[0]
    for with_hist in (False, True):
        kw_big = dict(sb_slots=sb_big, n_sbs=nsb_big, with_hist=with_hist)
        for name, fn in impls.items():
            call = (lambda f=fn, k=kw_big: f(big, ct, **k))
            ms, n_ops, names = device_ops(call, 10, between=flush)
            per[(name, "pool", with_hist)] = dict(
                device_ms=ms, device_ops=n_ops, names=names,
                bound_share=pool_bound / ms)
    del flush_buf
    for (name, where, with_hist), v in sorted(per.items()):
        log(f"access_scan {name} at {where} "
            f"({serve if where == 'serve' else SCAN_POOL}), with_hist="
            f"{with_hist}: {v['device_ms']:.5f} ms device, "
            f"{v['device_ops']:g} device operations a call {v['names']}"
            + (f" (L2 evicted before each call), {v['bound_share']:.3f} of "
               f"the {pool_bound:.5f} ms bound"
               if where == "pool" else ""))
    log(f"access_scan: exact at {list(tables)} words, with and without "
        f"hist; {_fmt(t)}, bound {b_ms:.7f} ms at N={n}; back to back "
        f"{t['ms']:.4f} ms a call (the wrapper's host cost)"
        + (f"; the earlier kernel and wrapper (five torch.empty outputs) "
           f"{t['was_ms']:.4f} ms a call" if was else ""))
    return dict(max_abs_err=0.0, bound_ms=b_ms, bound_by=b_by, **t,
                shape=f"table [{n}] int32, n_sbs {serve[2]}",
                cases={f"{k[0]}/{k[1]}/hist={k[2]}": v
                       for k, v in per.items()},
                pool_bound_ms=pool_bound)


def _migrate_was(path):
    """ops.migrate(...) of an earlier migrate.cu (its C entry: data,
    staging, src, dst, ok, n_moves, n_rows, row_bytes, stream: a gather
    launch and a scatter launch), built from `path` with the port's nvcc
    flags into build/; for comparing in one run. Counts no launch."""
    import ctypes
    import torch
    from repro_torch.kernels import build, ops
    out = ROOT / "build" / "was" / "migrate.so"
    out.parent.mkdir(parents=True, exist_ok=True)
    subprocess.run([build.nvcc(), *build.NVCC_FLAGS, "-o", str(out),
                    str(path)], check=True, capture_output=True, timeout=600)
    lib = ctypes.CDLL(str(out))
    P, I = ctypes.c_void_p, ctypes.c_int
    lib.migrate.argtypes = (P,) * 5 + (I, I, ctypes.c_longlong, P)
    lib.migrate.restype = I

    def call(data, src, dst, ok):
        staging = torch.empty((src.shape[0], data.shape[1]), dtype=data.dtype,
                              device=data.device)
        rc = lib.migrate(data.data_ptr(), staging.data_ptr(), src.data_ptr(),
                         dst.data_ptr(), ok.data_ptr(), src.shape[0],
                         data.shape[0], data.shape[1] * data.element_size(),
                         ops._stream())
        if rc:
            raise RuntimeError(f"the earlier migrate failed: {rc}")
        return data
    return call


def _six_moves(dev):
    """(src, dst, ok): hot moves, then cold moves landing in slots the hot
    moves vacated, plus masked moves that point at live rows."""
    import torch
    return (torch.tensor([3, 5, 0, 7, 9, 4], dtype=torch.int32, device=dev),
            torch.tensor([12, 13, 1, 3, 5, 2], dtype=torch.int32, device=dev),
            torch.tensor([1, 1, 0, 1, 1, 0], dtype=torch.bool, device=dev))


def _migrate_lists(g, n_slots, budget, dev):
    """The collector's shape, 2 x `budget` moves (hot then cold, a tenth
    masked) over distinct slots, as three lists with one mask: "hazard", in
    which the cold movers land in the slots the hot movers vacate (the
    cold moves copy late), "disjoint", in which no destination is a source
    (the collector's usual pattern: sources are live slots, destinations
    free ones), and "swap", in which hot and cold mover i trade slots
    (every live move whose partner is live is staged)."""
    import torch
    perm = torch.randperm(n_slots, generator=g)[:4 * budget]
    ok = torch.rand(2 * budget, generator=g).lt(0.9).to(dev)
    hot, cold = perm[:budget], perm[budget:2 * budget]
    lists = (("hazard", torch.cat([hot, cold]),
              torch.cat([perm[2 * budget:3 * budget], hot])),
             ("disjoint", perm[:2 * budget], perm[2 * budget:]),
             ("swap", torch.cat([hot, cold]), torch.cat([cold, hot])))
    return {name: (s.to(dev, torch.int32), d.to(dev, torch.int32), ok)
            for name, s, d in lists}


def _migrate_exact(data, src, dst, ok, where, was=None):
    """Kernel (and the earlier kernel `was`) against the plain version and
    the three-phase model, exactly, scratch row zero. Returns the shares of
    the live moves that the kernel stages and that it copies late (in
    phase 3, straight across)."""
    import torch
    from repro_torch.kernels import ops, ref
    want = ref.migrate(data.clone(), src, dst, ok)
    phased, staged = ref.migrate_phased(data.clone(), src, dst, ok)
    impls = {"kernel": ops.migrate, **({"was": was} if was else {})}
    for name, fn in impls.items():
        got = fn(data.clone(), src, dst, ok)
        torch.cuda.synchronize()
        if not (torch.equal(got, want) and torch.equal(phased, want)) \
                or got[-1].any():
            raise AssertionError(f"migrate ({name}) differs at {where}")
    del got, want, phased
    live = ok & (dst >= 0) & (dst < data.shape[0])
    read = live & torch.isin(dst, src.clamp(0, data.shape[0] - 1)[live])
    n = max(int(live.sum()), 1)
    return dict(staged_share=int(staged.sum()) / n,
                late_share=int((read & ~staged).sum()) / n)


def _migrate_timed(data, src, dst, ok, was=None):
    """Times of a call (`timings`, library data[dst] = data[src]; device
    operations a call from its kernel trace), the bound over the live
    moves (2 x row bytes each, 9 bytes a lane) and, with `was`, the
    earlier kernel's device time in the same run."""
    from repro_torch.kernels import ops, ref
    sel_s, sel_d = src[ok].long(), dst[ok].long()

    def library():
        data[sel_d] = data[sel_s]
    call = (lambda: ops.migrate(data, src, dst, ok))
    t = timings(call, 100, lambda: ref.migrate(data, src, dst, ok), 20,
                library)
    if was:
        t["was_device_ms"] = device_ops(lambda: was(data, src, dst, ok),
                                        100)[0]
    n_ok = int(ok.sum())
    row_bytes = data.shape[1] * data.element_size()
    b_ms, b_by = bound(2 * n_ok * row_bytes + 9 * src.shape[0], 0, "bf16")
    return dict(t, bound_ms=b_ms, bound_by=b_by, n_ok=n_ok,
                row_bytes=row_bytes)


def _migrate_pool_cases(g, gd, dev, n_slots, w, dtype, budget, label,
                        was=None, one_op=False):
    """Phase 3's migrate at one pool [n_slots + 1, w] (scratch row last):
    six moves with the hot/cold overlap exact, and the hazard, disjoint and
    swap lists exact and timed. With `one_op`, a profiled call on the
    hazard list must be one device operation, the kernel (no memset).
    Returns {case: numbers}, with the staged and late shares."""
    import torch
    from repro_torch.kernels import ops
    data = torch.randn((n_slots + 1, w), generator=gd, device=dev,
                       dtype=dtype)
    data[-1] = 0
    _migrate_exact(data, *_six_moves(dev), f"{label}'s pool, six moves", was)
    res = {}
    for case, (src, dst, ok) in _migrate_lists(g, n_slots, budget,
                                               dev).items():
        shares = _migrate_exact(data, src, dst, ok,
                                f"{label}'s pool, {case}", was)
        r = res[case] = _migrate_timed(data, src, dst, ok, was)
        if one_op and case == "hazard":
            # operations counted in a short trace (a long one may drop
            # events)
            _, n_ops, names = device_ops(
                lambda: ops.migrate(data, src, dst, ok), 10)
            if n_ops != 1 or any("Memset" in x for x in names):
                raise AssertionError(f"migrate is {n_ops} device operations"
                                     f" a call ({names}), not one kernel")
        r.update(shares, max_abs_err=0.0, shape=(
            f"{case}: {r['n_ok']} of {2 * budget} moves of "
            f"{r['row_bytes']} B rows, pool [{n_slots + 1}, {w}] "
            f"{str(dtype).split('.')[-1]}"))
        log(f"migrate at {label}'s pool, {case} (staged share "
            f"{r['staged_share']:.4f}, late {r['late_share']:.4f}): exact; "
            f"{_fmt(r)} (library: data[dst]=data[src]),"
            f" {r['device_ops']:g} device operations a call, bound "
            f"{r['bound_ms']:.5f} ms"
            + (f"; the earlier kernel {r['was_device_ms']:.5f} ms device"
               if was else ""))
    del data
    torch.cuda.empty_cache()
    return res


def _migrate_graph_node(dev, n_slots, w, budget):
    """One call captured in a CUDA graph (on a stream that called it
    before) must be one kernel node, with the cooperative attribute, and
    no other node."""
    import torch
    from repro_torch.kernels import ops
    data = torch.zeros((n_slots + 1, w), device=dev, dtype=torch.bfloat16)
    src, dst, ok = _migrate_lists(torch.Generator().manual_seed(3), n_slots,
                                  budget, dev)["hazard"]
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        ops.migrate(data, src, dst, ok)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph(keep_graph=True)
    snap = ops.count_snapshot()
    with torch.cuda.graph(graph, stream=side):
        ops.migrate(data, src, dst, ok)
    ops.counts_since(snap)
    nodes = ops.graph_nodes(graph)
    if nodes != dict(nodes=1, kernels=1, cooperative=1):
        raise AssertionError(f"a captured migrate holds {nodes}, not one "
                             "cooperative kernel node")
    return nodes


def check_migrate(dev, pcfg, budget, olmoe_pcfg, was=None):
    """Exact against the plain version and the three-phase model
    (`ref.migrate_phased`) on a small fp32 table (the hot/cold overlap) and
    at chatglm3-6b's pool (16 KiB rows) and olmoe-1b-7b's (128 KiB rows),
    each on the hazard, disjoint and swap lists (`_migrate_lists`); timed
    at both pools with each case's staged and late shares; a profiled call
    one device operation at chatglm3-6b's hazard case; a captured call one
    cooperative kernel node.
    With `was` (an earlier migrate.cu, built by `_migrate_was`), that
    kernel is checked and timed at the same cases in the same run."""
    import torch
    g = torch.Generator().manual_seed(2)
    gd = torch.Generator(device=dev).manual_seed(2)
    data = torch.randn((17, 24), generator=g).to(dev)
    data[-1] = 0
    _migrate_exact(data, *_six_moves(dev), "[17, 24] fp32", was)
    nodes = _migrate_graph_node(dev, pcfg.n_slots, pcfg.slot_words, budget)
    log(f"migrate captured in a CUDA graph: {nodes}")
    res = {name: _migrate_pool_cases(g, gd, dev, pc.n_slots, pc.slot_words,
                                     torch.bfloat16, budget, name, was,
                                     one_op=name == "chatglm3-6b")
           for name, pc in (("chatglm3-6b", pcfg),
                            ("olmoe-1b-7b", olmoe_pcfg))}
    return dict(res["chatglm3-6b"]["hazard"], graph_nodes=nodes,
                cases=res, olmoe=res["olmoe-1b-7b"]["hazard"])


def _pa_inputs(g, dev, dtype, b, h, kv, d, bt, mb, n_slots, kind="random"):
    """q, the pool [n_slots, 2, bt, KV, D], tables and lengths. kind:
    "random" lengths in [1, bt * MB]; "full" (every lane at bt * MB);
    "edges" (lane 0 of length 0, lane 1 at full length with a -1 hole,
    lane 2 with a slot >= n_slots, clamped as XLA's gather clamps)."""
    import torch
    pool = torch.randn((n_slots, 2, bt, kv, d), generator=g).to(dev, dtype)
    q = torch.randn((b, h, d), generator=g).to(dev, dtype)
    lens = torch.randint(1, bt * mb + 1, (b,), generator=g, dtype=torch.int32)
    if kind == "full":
        lens[:] = bt * mb
    tables = torch.full((b, mb), -1, dtype=torch.int32)
    for i in range(b):
        used = -(-int(lens[i]) // bt)
        tables[i, :used] = torch.randperm(n_slots, generator=g)[:used].int()
    if kind == "edges":
        lens[0], lens[1] = 0, bt * mb - 1
        tables[1] = torch.randperm(n_slots, generator=g)[:mb].int()
        tables[1, mb // 2] = -1
        tables[2, 0] = n_slots + 3
    return q, pool, tables.to(dev), lens.to(dev)


def _pa_variant(dtype, rep, d):
    """The paged_attention variant each phase-3 case must run: bf16 with
    D % 16 == 0 on the tensor cores, at any REP."""
    import torch
    from repro_torch.kernels import ops
    if dtype == torch.bfloat16 and d % 16 == 0 and d <= 256:
        return ops.TENSOR_CORES
    return ops.CUDA_CORES


def _pa_timed(g, dev, shape):
    """paged_attention at `shape` (bf16, random lengths) timed beside its
    plain version, SDPA over the same K/V already gathered contiguous and
    repeated to every query head, and the bound."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import ops, ref
    q, pool, tables, lens = _pa_inputs(g, dev, torch.bfloat16, *shape)
    args = (q, pool[:, 0], pool[:, 1], tables, lens)
    b, h, kv, d, bt, mb, _ = shape
    rep = h // kv
    safe = tables.clamp(min=0).long()
    k = pool[safe, 0].reshape(b, mb * bt, kv, d).repeat_interleave(rep, 2) \
        .transpose(1, 2).contiguous()
    v = pool[safe, 1].reshape(b, mb * bt, kv, d).repeat_interleave(rep, 2) \
        .transpose(1, 2).contiguous()
    mask = (torch.arange(mb * bt, device=dev)[None] < lens[:, None]) \
        [:, None, None, :]
    qs = q[:, :, None, :]
    t = timings(lambda: ops.paged_attention(*args), 200,
                lambda: ref.paged_attention(*args), 20,
                lambda: F.scaled_dot_product_attention(qs, k, v,
                                                       attn_mask=mask))
    tokens = int(lens.sum())
    bytes_moved = (q.numel() * 2 * 2 + tokens * kv * d * 2 * 2
                   + tables.numel() * 5 + b * 4)
    b_ms, b_by = bound(bytes_moved, 4 * h * d * tokens, "bf16")
    variant = _pa_variant(torch.bfloat16, rep, d)
    groups, rg = ops._paged_groups(variant, rep, d)
    n_splits, pps = ops._paged_splits(b, kv * groups, mb, ops._n_sms(dev))
    log(f"paged_attention ({variant}, {n_splits} splits of {pps} pages, "
        f"{groups} group(s) of {rg} heads): {_fmt(t)} (library: SDPA), bound "
        f"{b_ms:.5f} ms at B={b} H={h} KV={kv} D={d} bt={bt} MB={mb}, "
        f"{tokens} live tokens")
    return dict(bound_ms=b_ms, bound_by=b_by, variant=variant,
                n_splits=n_splits, groups=groups, group_heads=rg,
                live_tokens=tokens, **t,
                shape=f"B={b} H={h} KV={kv} D={d} bt={bt} MB={mb} bf16")


def check_paged_attention(dev, mc, kv_cfg, pcfg, olmoe):
    """Every case against the plain version (2e-5 fp32, 2e-2 bf16, access
    bits exact), each logged with the split kernel's variant: the serve
    shape with random lengths, at full length and with the edge lanes, in
    both dtypes; the same at granite's decode shape (H=48 over one KV head:
    REP 48, several blocks per KV head) and at olmoe's serve shape `olmoe`
    (H = KV = 16: REP 1); the CPU tests' shapes; REP 1, 4,
    8, 16, 32, 40, 48 x D 16, 64, 128, 256 x bt 4, 8, 16 in bf16 with the
    edge lanes (one page per split, most splits of the short lanes empty).
    Then timed at the serve shape, granite's and olmoe's (random lengths)
    beside the plain version, SDPA and the bound; at granite's the kernel
    must be no slower than SDPA in device time."""
    import torch
    from repro_torch.kernels import ops, ref
    g = torch.Generator().manual_seed(3)
    main = (kv_cfg.batch, mc.num_heads, mc.num_kv_heads, mc.resolved_head_dim,
            kv_cfg.block_tokens, kv_cfg.max_blocks, pcfg.n_slots + 1)
    granite = (kv_cfg.batch, 48, 1, 128, kv_cfg.block_tokens,
               kv_cfg.max_blocks, pcfg.n_slots + 1)
    tols = {torch.float32: 2e-5, torch.bfloat16: 2e-2}
    cases = [(main, dtype, kind) for kind in ("random", "full", "edges")
             for dtype in (torch.bfloat16, torch.float32)]
    cases += [(shape, dtype, "random")
              for shape in ((2, 8, 2, 16, 4, 6, 32), (3, 4, 4, 32, 8, 4, 32),
                            (1, 8, 1, 64, 16, 3, 32), (2, 48, 1, 16, 4, 6, 32))
              for dtype in (torch.float32, torch.bfloat16)]
    cases += [((4, 2 * rep, 2, d, bt, 6, 32), torch.bfloat16, "edges")
              for rep in (1, 4, 8, 16, 32, 40, 48) for d in (16, 64, 128, 256)
              for bt in (4, 8, 16)]
    cases += [(shape, dtype, kind) for shape in (granite, olmoe)
              for kind in ("random", "full", "edges")
              for dtype in (torch.bfloat16, torch.float32)]
    main_err, olmoe_err, ran, worst = None, 0.0, collections.Counter(), {}
    for shape, dtype, kind in cases:
        q, pool, tables, lens = _pa_inputs(g, dev, dtype, *shape, kind=kind)
        args = (q, pool[:, 0], pool[:, 1], tables, lens)
        before = dict(ops.paged_variants)
        got_o, got_t = ops.paged_attention(*args)
        want_o, want_t = ref.paged_attention(*args)
        torch.cuda.synchronize()
        variant = [k for k in before if ops.paged_variants[k] != before[k]]
        err = (got_o.float() - want_o.float()).abs().max().item()
        rep_ = shape[1] // shape[2]
        want_v = _pa_variant(dtype, rep_, shape[3])
        groups = ops._paged_groups(want_v, rep_, shape[3])[0]
        log(f"paged_attention {kind} {shape[:6]} {str(dtype)[6:]}: {variant}"
            f"{f' x{groups} groups' if groups > 1 else ''}, max |err| "
            f"{err:.3g}")
        if variant != [want_v]:
            raise AssertionError(f"paged_attention {shape} {dtype} ran "
                                 f"{variant}, want {want_v}")
        if not err < tols[dtype] or not torch.equal(got_t, want_t):
            raise AssertionError(f"paged_attention {shape} {dtype} {kind}: "
                                 f"err {err} (tol {tols[dtype]}) or touched")
        if kind == "edges" and got_o[0].any():
            raise AssertionError("a lane of length 0 did not get zeros")
        if main_err is None:
            main_err = err
        if shape == olmoe and dtype == torch.bfloat16:
            olmoe_err = max(olmoe_err, err)
        key = (str(dtype)[6:], want_v, "REP>32" if rep_ > 32 else "REP<=32")
        worst[key] = max(worst.get(key, 0.0), err)
        ran[want_v] += 1
        del q, pool, args
    log(f"paged_attention: {len(cases)} cases within 2e-5 (fp32) / 2e-2 "
        f"(bf16), access bits exact, {dict(ran)}; max |err| {worst}")
    res = dict(max_abs_err=main_err, **_pa_timed(g, dev, main))
    res["granite"] = _pa_timed(g, dev, granite)
    res["olmoe"] = dict(_pa_timed(g, dev, olmoe), max_abs_err=olmoe_err)
    gr = res["granite"]
    if gr["variant"] != ops.TENSOR_CORES or \
            not gr["device_ms"] <= gr["library_device_ms"]:
        raise AssertionError(f"paged_attention at granite's shape: "
                             f"{gr['variant']}, {gr['device_ms']} ms against "
                             f"SDPA's {gr['library_device_ms']} ms")
    return res


# the CPU tests' sweep (tests/test_kernels.py): (b, s, h, kv, d) x masks
FLASH_SWEEP = [(1, 128, 4, 4, 32), (2, 256, 4, 2, 64), (1, 256, 8, 1, 16)]
FLASH_MASKS = [(True, 0), (True, 64), (False, 0)]
# bf16 edges of the tensor-core kernel (tests/test_torch_gpu.py's
# FLASH_TC_EDGES): (b, s, h, kv, d, causal, window)
FLASH_TC_EDGES = [
    (2, 64, 4, 4, 64, True, 0), (2, 100, 6, 2, 32, True, 0),
    (1, 100, 32, 2, 128, False, 0), (2, 256, 3, 1, 96, True, 0),
    (1, 384, 6, 2, 16, True, 16), (1, 512, 32, 2, 128, True, 64),
    (2, 384, 4, 4, 128, True, 200), (1, 256, 16, 1, 64, False, 64),
    (1, 128, 9, 3, 96, False, 200), (2, 512, 16, 16, 32, True, 0),
    (2, 384, 32, 32, 80, True, 0)]


def _flash_run(fn):
    """fn()'s result and the flash_attention variant it launched."""
    import torch
    from repro_torch.kernels import ops
    before = dict(ops.flash_variants)
    out = fn()
    torch.cuda.synchronize()
    ran = [k for k in before if ops.flash_variants[k] != before[k]]
    if len(ran) != 1:
        raise AssertionError(f"flash variants {before} -> "
                             f"{ops.flash_variants}: want one launch")
    return out, ran[0]


def check_flash_attention(dev, mc, olmoe, zamba, enc, vlm):
    """Every case against the plain version (2e-5 fp32, 2e-2 bf16), with
    the variant that ran: the CPU tests' sweep and the prefill shape in
    both dtypes (chatglm3-6b's, olmoe-1b-7b's, whose H = KV = 16,
    zamba2-2.7b's shared block, H = KV = 32 at D = 80,
    seamless-m4t-large-v2's encoder, non-causal over its 1024 frames, and
    decoder, H = KV = 16 at D = 64, and qwen2-vl-72b's, H = 64 over KV = 8
    at D = 128, also its shard on a card of the (2, 2) mesh of
    --dist-only, B = 1 and H = 32 over KV = 4), the
    tensor-core kernel's bf16 edges, and bf16 views of a
    fused projection (the tensor cores) and one TMA cannot describe (the
    CUDA cores). bf16 cases other than that view must run on the tensor
    cores, fp32 ones on the CUDA cores. Then the tensor-core kernel timed
    at the prefill shape beside the plain version, SDPA and the bound, and
    the CUDA-core kernel on the same bf16 inputs (as a view TMA cannot
    describe) in the same run; then the tensor-core kernel at olmoe's,
    zamba2's, seamless's (encoder and decoder) and qwen2-vl's prefill
    shapes, beside the plain version, SDPA (non-causal for the encoder)
    and the bound."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import ops, ref
    g = torch.Generator(device=dev).manual_seed(4)

    def inputs(b, s, h, kv, d, dtype):
        return [torch.randn(shape, generator=g, device=dev).to(dtype)
                for shape in ((b, s, h, d), (b, s, kv, d), (b, s, kv, d))]

    def odd_view(x):
        """x as a view one element past an aligned base, position stride
        not a multiple of 8: a view TMA cannot describe."""
        b, s, h, d = x.shape
        big = torch.empty((b, s, h * d + 1), dtype=x.dtype, device=dev)
        view = big[..., 1:].view(b, s, h, d)
        view.copy_(x)
        return view

    tols = {torch.float32: 2e-5, torch.bfloat16: 2e-2}
    main = (PREFILL_B, PREFILL_S, mc.num_heads, mc.num_kv_heads,
            mc.resolved_head_dim)
    cases = [(shape, causal, window, dtype, "sweep")
             for shape in FLASH_SWEEP for causal, window in FLASH_MASKS
             for dtype in tols]
    olmoe_shape, zamba_shape, enc_shape, vlm_shape = (
        (PREFILL_B, PREFILL_S, c.num_heads, c.num_kv_heads,
         c.resolved_head_dim) for c in (olmoe, zamba, enc, vlm))
    # (name, shape, causal) of the prefill shapes timed after `main`
    more_shapes = [("olmoe", olmoe_shape, True),
                   ("zamba2", zamba_shape, True),
                   ("seamless_encoder", (PREFILL_B, enc.encoder_seq_len)
                    + enc_shape[2:], False),
                   ("seamless", enc_shape, True),
                   ("qwen2_vl", vlm_shape, True)]
    # the shard each card of --dist-only (c) runs: qwen2-vl's batch and
    # heads halved on the (2, 2) mesh
    vlm_rank = (PREFILL_B // 2, PREFILL_S, vlm.num_heads // 2,
                vlm.num_kv_heads // 2, vlm.resolved_head_dim)
    cases += [(shape, causal, 0, dtype, f"prefill {name}")
              for name, shape, causal in [("", main, True)] + more_shapes
              + [("qwen2_vl (2, 2) shard", vlm_rank, True)]
              for dtype in (torch.bfloat16, torch.float32)]
    cases += [(e[:5], e[5], e[6], torch.bfloat16, "edge")
              for e in FLASH_TC_EDGES]
    cases += [((2, 256, 8, 2, 64), True, 0, torch.bfloat16, "fused view"),
              ((2, 256, 8, 2, 64), True, 0, torch.bfloat16, "odd view")]
    worst, ran = {}, collections.Counter()
    for shape, causal, window, dtype, kind in cases:
        if kind == "fused view":
            b, s, h, kv, d = shape
            fused = torch.randn((b, s, (h + 2 * kv) * d), generator=g,
                                device=dev).to(dtype)
            q, k, v = (fused[..., :h * d].view(b, s, h, d),
                       fused[..., h * d:(h + kv) * d].view(b, s, kv, d),
                       fused[..., (h + kv) * d:].view(b, s, kv, d))
        else:
            q, k, v = inputs(*shape, dtype)
            if kind == "odd view":
                q = odd_view(q)
        got, variant = _flash_run(lambda: ops.flash_attention(
            q, k, v, causal=causal, window=window))
        want = ref.flash_attention(q.contiguous(), k.contiguous(),
                                   v.contiguous(), causal=causal,
                                   window=window)
        torch.cuda.synchronize()
        err = (got.float() - want.float()).abs().max().item()
        expect = (ops.TENSOR_CORES if dtype == torch.bfloat16
                  and kind != "odd view" else ops.CUDA_CORES)
        log(f"flash_attention {kind} {shape} causal={causal} window={window} "
            f"{str(dtype)[6:]}: {variant}, max |err| {err:.3g}")
        if variant != expect:
            raise AssertionError(f"flash_attention {shape} {dtype} {kind} "
                                 f"ran on {variant}, want {expect}")
        if not err < tols[dtype]:
            raise AssertionError(f"flash_attention {shape} causal={causal} "
                                 f"window={window} {dtype}: err {err}")
        key = (kind.strip(), str(dtype)[6:], variant)
        worst[key] = max(worst.get(key, 0.0), err)
        ran[variant] += 1
    log(f"flash_attention: {len(cases)} cases within 2e-5 (fp32) / 2e-2 "
        f"(bf16), {dict(ran)}; max |err| {worst}")
    def timed(shape, causal=True):
        """The kernel at `shape` (bf16) beside the plain version, SDPA and
        the bound: causal, 2 x B x H x D x S(S+1) operations (the two
        products over the S(S+1)/2 pairs a causal mask keeps), else
        4 x B x H x D x S^2."""
        q, k, v = inputs(*shape, torch.bfloat16)
        qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
        _, variant = _flash_run(
            lambda: ops.flash_attention(q, k, v, causal=causal))
        t = timings(lambda: ops.flash_attention(q, k, v, causal=causal), 20,
                    lambda: ref.flash_attention(q, k, v, causal=causal), 3,
                    lambda: F.scaled_dot_product_attention(
                        qt, kt, vt, is_causal=causal, enable_gqa=True))
        b, s, h, kv, d = shape
        mask = "causal" if causal else "non-causal"
        b_ms, b_by = bound(b * s * (2 * h + 2 * kv) * d * 2,
                           (2 * b * h * d * s * (s + 1) if causal
                            else 4 * b * h * d * s * s), "bf16")
        log(f"flash_attention ({variant}): {_fmt(t)} (library: SDPA), bound "
            f"{b_ms:.5f} ms ({b_by}) at B={b} S={s} H={h} KV={kv} D={d} "
            f"bf16 {mask}")
        return (q, k, v), dict(
            bound_ms=b_ms, bound_by=b_by, variant=variant, **t,
            shape=f"B={b} S={s} H={h} KV={kv} D={d} bf16 {mask}")

    (q, k, v), res = timed(main)
    q_odd = odd_view(q)
    _, cc_variant = _flash_run(lambda: ops.flash_attention(q_odd, k, v))
    cc_ms = cuda_time(lambda: ops.flash_attention(q_odd, k, v), 3, warmup=1)
    log(f"flash_attention: the {cc_variant} kernel on the same inputs "
        f"{cc_ms:.4f} ms per call")
    del q_odd, q, k, v
    more = {}
    for name, shape, causal in more_shapes:
        more[name] = timed(shape, causal)[1]
        more[name]["max_abs_err"] = worst[(f"prefill {name}", "bfloat16",
                                           more[name]["variant"])]
        more[name]["max_abs_err_fp32"] = worst[(f"prefill {name}", "float32",
                                                ops.CUDA_CORES)]
    return dict(res, max_abs_err=worst[("prefill", "bfloat16",
                                        res["variant"])],
                cuda_cores_ms=cc_ms, **more)


# the CPU tests' sweep (tests/test_kernels.py): (b, s, c, n)
SCAN_SWEEP = [(1, 64, 8, 16), (2, 128, 16, 8), (1, 32, 4, 4)]


def check_mamba_scan(dev, mm, zamba):
    """Bit for bit against the plain version at the sweep's shapes, at
    falcon-mamba's decode shape (B=8, S=1) and at its prefill shape, and at
    zamba2's mamba2 chunk carry in a prefill (B=2, S = 4096 / 128 chunks,
    C = N = 64 states, N = nh * 64 = 5120 head channels: 327,680 lanes a
    sequence) and in a decode step (B=8, one chunk of one token), each in
    fp32 and bf16 inputs with a in [0.3, 1); then timed at falcon-mamba's
    prefill shape and at zamba2's prefill carry in fp32, the inputs the
    models give it. Its backward kernel, `mamba_scan_bwd`, likewise bit for
    bit against `ref.mamba_scan_bwd` at the sweep's shapes, falcon-mamba's
    prefill shape and zamba2's carry (the shapes a train step gives it),
    in fp32 and bf16, and timed at the last two in fp32 (under "bwd")."""
    import torch
    from repro_torch.kernels import ops, ref
    g = torch.Generator(device=dev).manual_seed(5)
    c, n = mm.d_model * mm.ssm_expand, mm.ssm_state_dim
    main = (PREFILL_B, PREFILL_S, c, n)
    zn, zlanes = zamba.ssm_state_dim, zamba.d_model * zamba.ssm_expand
    carry = (PREFILL_B, PREFILL_S // SSD_CHUNK, zn, zlanes)
    carry_decode = (DECODE_B, 1, zn, zlanes)

    def inputs(shape, dtype):
        a = (0.3 + 0.7 * torch.rand(shape, generator=g, device=dev)).to(dtype)
        b = torch.randn(shape, generator=g, device=dev).to(dtype)
        h0 = torch.randn((shape[0],) + shape[2:], generator=g, device=dev)
        return a, b, h0

    def bwd_inputs(shape, dtype):
        a, b, h0 = inputs(shape, dtype)
        h_all = ops.mamba_scan(a, b, h0)[0]
        del b
        return (a, h0, h_all, torch.randn(shape, generator=g, device=dev),
                torch.randn(h0.shape, generator=g, device=dev))

    shapes = SCAN_SWEEP + [(DECODE_B, 1, c, n), main, carry, carry_decode]
    cases = [(shape, dtype) for shape in shapes
             for dtype in (torch.float32, torch.bfloat16)]
    for shape, dtype in cases:
        args = inputs(shape, dtype)
        got = ops.mamba_scan(*args)
        want = ref.mamba_scan(*args)
        torch.cuda.synchronize()
        err = max((x - y).abs().max().item() for x, y in zip(got, want))
        if err != 0 or not all(map(torch.equal, got, want)):
            raise AssertionError(f"mamba_scan {shape} {dtype}: max |err| "
                                 f"{err}, want 0")
        del args, got, want
    log(f"mamba_scan: bit for bit (h_all, h_last) at {len(cases)} cases: "
        f"{shapes} x fp32 / bf16 inputs")
    bwd_shapes = SCAN_SWEEP + [main, carry]
    bwd_cases = [(shape, dtype) for shape in bwd_shapes
                 for dtype in (torch.float32, torch.bfloat16)]
    for shape, dtype in bwd_cases:
        args = bwd_inputs(shape, dtype)
        got = ops.mamba_scan_bwd(*args)
        want = ref.mamba_scan_bwd(*args)
        torch.cuda.synchronize()
        err = max((x.float() - y.float()).abs().max().item()
                  for x, y in zip(got, want))
        if err != 0 or not all(map(torch.equal, got, want)) or \
                [x.dtype for x in got] != [dtype, dtype, torch.float32]:
            raise AssertionError(f"mamba_scan_bwd {shape} {dtype}: max "
                                 f"|err| {err}, want 0")
        del args, got, want
        torch.cuda.empty_cache()
    log(f"mamba_scan_bwd: bit for bit (da, db, dh0) at {len(bwd_cases)} "
        f"cases: {bwd_shapes} x fp32 / bf16 inputs")

    def timed(shape, iters, what, bwd=False):
        if bwd:
            args = bwd_inputs(shape, torch.float32)
            fn, plain = ops.mamba_scan_bwd, ref.mamba_scan_bwd
        else:
            args = inputs(shape, torch.float32)
            fn, plain = ops.mamba_scan, ref.mamba_scan
        t = timings(lambda: fn(*args), iters, lambda: plain(*args), 3)
        b, s, c_, n_ = shape
        elems, lanes = b * s * c_ * n_, b * c_ * n_
        # forward: a, b read, h_all written; h0 read, h_last written. bwd:
        # a, h_all, dh_all read, da, db written; h0, dh_last read, dh0
        # written. fp32 operations: 2 a step forward, 3 backward
        b_ms, b_by = bound(
            (5 * elems + 3 * lanes) * 4 if bwd else
            (3 * elems + 2 * lanes) * 4, (3 if bwd else 2) * elems, "fp32")
        name = "mamba_scan_bwd" if bwd else "mamba_scan"
        log(f"{name} ({what}): {_fmt(t)} (no library call), bound "
            f"{b_ms:.5f} ms ({b_by}) at B={b} S={s} C={c_} N={n_} fp32")
        del args
        torch.cuda.empty_cache()
        return dict(max_abs_err=0.0, bound_ms=b_ms, bound_by=b_by, **t,
                    shape=f"B={b} S={s} C={c_} N={n_} fp32")
    return dict(timed(main, 10, "falcon-mamba prefill"),
                zamba2=timed(carry, 50, "zamba2 prefill carry"),
                bwd=dict(timed(main, 10, "falcon-mamba prefill", bwd=True),
                         zamba2=timed(carry, 50, "zamba2 train carry",
                                      bwd=True)))


# ---------------------------------------------------------------------------
# phase 4: the serving path at full width and depth
# ---------------------------------------------------------------------------
@contextlib.contextmanager
def watch_windows(srv):
    """Stamps the start of each serve window (its one upload of inputs)
    and counts the synchronising CUDA operations of the run (sync debug
    mode "warn") by where each falls: inside window i (uploaded, not yet
    dispatched), at window i's close (dispatched, lanes not yet scheduled),
    or between windows."""
    import torch
    w = dict(starts=[], inside=collections.Counter(),
             close=collections.Counter(), between=0)
    upload = srv._upload

    def stamped(host):
        w["starts"].append(time.perf_counter())
        return upload(host)

    def on_warning(message, *args, **kwargs):
        if "synchronizing CUDA operation" not in str(message):
            return
        n_up, n_disp = len(w["starts"]), srv.dispatches
        if n_up == n_disp + 1:
            w["inside"][n_up] += 1
        elif n_up == n_disp == len(srv.serve_log) + 1:
            w["close"][n_disp] += 1
        else:
            w["between"] += 1

    srv._upload = stamped
    with warnings.catch_warnings():
        warnings.simplefilter("always")
        warnings.showwarning = on_warning
        torch.cuda.set_sync_debug_mode("warn")
        try:
            yield w
        finally:
            torch.cuda.set_sync_debug_mode("default")
            del srv._upload


def _serve_run(srv, params, reqs, label):
    """One counted serve: every kernel's launch count reset just before
    and read just after, CUDA sync debug mode on; then phase 4's gates."""
    import torch
    from repro_torch.kernels import ops
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launches()
    t0 = time.perf_counter()
    with watch_windows(srv) as watch:
        results = srv.serve(params, reqs)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    launches = dict(ops.launches)
    paged_variants = dict(ops.paged_variants)
    windows = len(srv.serve_log)
    moved = sum(r["moved_to_hot"] + r["moved_to_cold"] for r in srv.reports)
    n_tok = sum(len(r.tokens) for r in results)
    steps = windows * srv.cfg.collect_every
    peak_rss = max(e["rss_bytes"] for e in srv.serve_log)
    final_rss = srv.kv_rss_bytes()
    log(f"serve ({label}): {len(results)} requests, {n_tok} tokens in "
        f"{dt:.2f} s ({n_tok / dt:.1f} tok/s, {steps} model steps, "
        f"{dt / steps * 1e3:.1f} ms/step), {windows} windows, "
        f"{srv.dispatches} dispatches, {srv.replays} graph replays, "
        f"{moved:.0f} rows migrated, peak KV RSS {peak_rss / 2**20:.1f} "
        f"MiB, final {final_rss:.0f} B, peak device memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    log(f"serve ({label}) launches: {launches}; paged_attention by "
        f"variant: {paged_variants}")
    close = [watch["close"][i] for i in range(1, windows + 1)]
    log(f"serve ({label}) syncs (CUDA sync debug mode): "
        f"{sum(watch['inside'].values())} inside windows, {sum(close)} at "
        f"the {windows} window closes (per window: {sorted(set(close))}), "
        f"{watch['between']} between windows (the reset before the first)")
    if len(results) != N_REQUESTS or any(
            not r.tokens or r.finish_reason not in ("eos", "length")
            for r in results):
        raise AssertionError(f"{label}: not every request completed")
    for name in HADES_KERNELS:
        if launches[name] <= 0:
            raise AssertionError(f"{label}: {name} was not launched on the "
                                 "serve path")
    if launches["flash_attention"]:
        raise AssertionError(f"{label}: flash_attention launched on the "
                             "serve path")
    if paged_variants != {ops.TENSOR_CORES: launches["paged_attention"],
                          ops.CUDA_CORES: 0}:
        raise AssertionError(f"{label}: paged_attention ran {paged_variants}"
                             f" of {launches['paged_attention']} launches; "
                             "want every one on the tensor cores")
    if moved <= 0:
        raise AssertionError(f"{label}: no rows migrated over the run")
    if watch["inside"]:
        raise AssertionError(f"{label}: host syncs inside windows "
                             f"{watch['inside']}")
    if close != [1] * windows:
        raise AssertionError(f"{label}: syncs at the window closes: {close},"
                             " want exactly one per window")
    if final_rss != 0:
        raise AssertionError(f"{label}: KV RSS {final_rss} after the drain")
    summary = dict(requests=len(results), tokens=n_tok, seconds=dt,
                   tok_per_s=n_tok / dt, windows=windows, steps=steps,
                   ms_per_step=dt / steps * 1e3, rows_migrated=moved,
                   graph_replays=srv.replays, launches=launches,
                   peak_kv_rss_bytes=peak_rss, syncs_inside_windows=0,
                   syncs_per_window_close=1,
                   syncs_between_windows=watch["between"],
                   paged_attention_variants=paged_variants,
                   peak_device_bytes=torch.cuda.max_memory_allocated())
    return results, summary, watch["starts"]


def serve_full(dev, arch="chatglm3-6b"):
    """Phase 4 (phase 9(a) for olmoe-1b-7b) in graph mode (the default on
    the card: every window one CUDA graph replay) at full width and depth,
    phase 5 on it; then, on a second server over the model's first
    EAGER_LAYERS layers (the same weights), the same requests in graph
    mode and in eager mode (op by op), the eager run traced: the greedy
    tokens, the final pool metadata and the launch counts of the two must
    be identical. Every model step launches paged_attention once per
    layer, and an MoE config's capacity at the lanes' batch drops no
    token."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.models import moe
    from repro_torch.models.model import Model
    from repro_torch.runtime.server import Request, Server, ServerConfig
    cfg = get_config(arch)
    if cfg.num_experts and moe.capacity(SERVE["batch"], cfg) < SERVE["batch"]:
        raise AssertionError(f"{arch}: capacity {moe.capacity(SERVE['batch'], cfg)}"
                             f" < {SERVE['batch']} lanes: decode would drop")
    model = Model(cfg, device="cuda")
    t0 = time.perf_counter()
    params = model.init(torch.Generator(device=dev).manual_seed(0))
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in _leaves(params))
    log(f"{arch}: {cfg.num_layers} layers, d_model {cfg.d_model}, "
        f"{n_params / 1e9:.3f} B params ({str(cfg.dtype)}), init "
        f"{time.perf_counter() - t0:.1f} s")
    rng = np.random.default_rng(0)
    reqs = [Request(prompt=rng.integers(0, cfg.vocab_size,
                                        int(rng.integers(32, 65))).tolist(),
                    max_new=MAX_NEW) for _ in range(N_REQUESTS)]

    def graph_run(srv, params, label):
        # warm-up: one short request, which captures the serve window's
        # graph (its first window runs eagerly, the capture follows; not
        # counted)
        t0 = time.perf_counter()
        srv.serve(params, [Request(prompt=[1, 2, 3], max_new=2)])
        torch.cuda.synchronize()
        log(f"warm-up serve with the capture: {time.perf_counter() - t0:.2f}"
            f" s, {len(srv._graphs)} graph(s)")
        results, run, starts = _serve_run(srv, params, reqs, label)
        layers = srv.model.cfg.num_layers
        if run["launches"]["paged_attention"] != run["steps"] * layers:
            raise AssertionError(f"{run['launches']['paged_attention']} "
                                 f"paged_attention launches in {run['steps']}"
                                 f" steps of {layers} layers")
        if srv.replays != run["windows"]:
            raise AssertionError(f"{srv.replays} graph replays in "
                                 f"{run['windows']} windows, want one each")
        return results, run, starts

    def traced_kernels(label, run):
        traced = {k: h["launches"]
                  for k, h in run["trace"]["hades_kernels"].items()}
        if any(n * run["windows"] != 2 * run["launches"][k]
               for k, n in traced.items()):
            raise AssertionError(
                f"{label}: {traced} kernels in 2 traced windows do not "
                f"scale to the {run['windows']} windows' launch counts "
                f"{run['launches']}")

    srv = Server(model, ServerConfig(**SERVE))
    _, graph, starts = graph_run(srv, params, f"{arch} graph")
    graph["trace"] = trace_serve(srv, params, reqs, starts)
    traced_kernels("graph", graph)
    del srv

    # op by op a step is host-bound, its wall proportional to the layers
    cut = _cut(arch, layers=EAGER_LAYERS)
    cut_params = dict(params, layers=params["layers"][:EAGER_LAYERS])
    srv = Server(Model(cut, device="cuda"), ServerConfig(**SERVE))
    label = f"{arch} {EAGER_LAYERS} layers"
    results, cut_graph, _ = graph_run(srv, cut_params, f"{label} graph")
    tokens = [r.tokens for r in results]
    final = {k: v.clone() for k, v in _flat(srv.state).items()}
    srv._eager = True
    results, eager, starts = _serve_run(srv, cut_params, reqs,
                                        f"{label} eager")
    if srv.replays:
        raise AssertionError("the eager serve replayed a graph")
    if [r.tokens for r in results] != tokens:
        raise AssertionError("greedy tokens differ between graph and eager")
    flat = _flat(srv.state)
    for k, v in final.items():
        if not k.endswith("data") and not torch.equal(v, flat[k]):
            raise AssertionError(f"final pool metadata differs at {k}")
    data_err = (final["pool/data"].float()
                - flat["pool/data"].float()).abs().max().item()
    eager["trace"] = trace_serve(srv, cut_params, reqs, starts,
                                 by_origin=True)
    srv._eager = False
    # the graph run's counts are added per replay from what its capture
    # recorded: they must be the eager run's, counted at the wrappers, and
    # the kernels that the eager run's trace found in two windows, per
    # window
    for key in ("launches", "paged_attention_variants"):
        if cut_graph[key] != eager[key]:
            raise AssertionError(f"{key}: graph {cut_graph[key]} vs eager "
                                 f"{eager[key]}")
    traced_kernels("eager", eager)
    log(f"{label} serve graph vs eager: tokens, final pool metadata and "
        f"launch counts identical, the traced kernels per window times the "
        f"windows equal to the counts, pool data max |err| {data_err:.3g}; "
        f"wall {cut_graph['ms_per_step']:.2f} vs {eager['ms_per_step']:.2f} "
        f"ms/step, {cut_graph['tok_per_s']:.1f} vs {eager['tok_per_s']:.1f} "
        "tok/s")
    summary = dict(graph, layers=cfg.num_layers, params=n_params,
                   eager=dict(eager, layers=EAGER_LAYERS),
                   graph_at_eager_depth=cut_graph,
                   graph_vs_eager=dict(layers=EAGER_LAYERS,
                                       tokens_identical=True,
                                       metadata_identical=True,
                                       pool_data_max_abs_err=data_err))
    launches, steps = graph["launches"], graph["steps"]
    del params, cut_params, srv, final
    torch.cuda.empty_cache()
    return launches, summary, steps


# ---------------------------------------------------------------------------
# phase 5: where the serve time goes
# ---------------------------------------------------------------------------
def _busy_us(intervals) -> float:
    """Length of the union of [start, end) intervals (us)."""
    total, cur_s, cur_e = 0.0, None, None
    for s, e in sorted(intervals):
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                total += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        total += cur_e - cur_s
    return total


# the port's functions of a serve window that the eager trace labels with
# a record_function range each (`_labelled`), innermost label winning
LABELLED = {
    "repro_torch.models.layers": ("embed", "rms_norm", "mlp", "positional",
                                  "logits_head"),
    "repro_torch.models.transformer": ("_qkv", "decode_layer_step",
                                       "attn_ffn_block", "encoder_forward",
                                       "_enc_kv", "_cross"),
    "repro_torch.models.attention": ("cross_attention",),
    "repro_torch.models.ssm": ("mamba2_forward", "causal_conv"),
    "repro_torch.models.moe": ("moe_block", "_route", "_experts"),
    "repro_torch.models.kvcache": ("append_layer", "attend",
                                   "_record_touched", "advance_pos",
                                   "free_lanes", "admit_lanes"),
    "repro_torch.core.pool": ("apply_op", "superblock_stats", "rss_bytes"),
    "repro_torch.core.freelist": ("pop", "push", "pop_region", "restock",
                                  "first_occurrence"),
    "repro_torch.core.object_table": ("set_drop", "add_drop",
                                      "record_access",
                                      "clear_access_and_atc"),
    "repro_torch.core.collector": ("classify", "_select_movers",
                                   "_plan_moves", "collect"),
    "repro_torch.core.policy": ("update",),
    "repro_torch.runtime.sampling": ("sample",),
    "repro_torch.kernels.ops": ("paged_attention", "access_scan", "migrate",
                                "flash_attention", "mamba_scan",
                                "mamba_scan_bwd"),
    "repro_torch.optim.adamw": ("adamw_update",),
}


_LABELS = {f"{m.rsplit('.', 1)[1]}.{n}" for m, ns in LABELLED.items()
           for n in ns}


@contextlib.contextmanager
def _labelled():
    """Wraps each function of LABELLED in a torch.profiler.record_function
    range named after it ("freelist.pop"), so that a trace names the code
    that launched each device operation; restores them after."""
    import importlib
    from torch.profiler import record_function
    saved = []
    for mod_name, names in LABELLED.items():
        mod = importlib.import_module(mod_name)
        for name in names:
            fn = getattr(mod, name)
            label = f"{mod_name.rsplit('.', 1)[1]}.{name}"   # in _LABELS

            def wrapped(*a, _fn=fn, _label=label, **kw):
                with record_function(_label):
                    return _fn(*a, **kw)
            saved.append((mod, name, fn))
            setattr(mod, name, wrapped)
    try:
        yield
    finally:
        for mod, name, fn in saved:
            setattr(mod, name, fn)


def _origin(e, labels):
    """(port functions, aten ops) of a host op that launched device work:
    e.g. ("kvcache.append_layer>pool.apply_op>freelist.pop",
    "aten::clone>aten::copy_"), from its enclosing profiler ranges (the
    innermost three port functions)."""
    ops, port, op = [], [], e
    while op is not None:
        if op.name.startswith("aten::"):
            ops.insert(0, op.name)
        elif op.name in labels:
            port.insert(0, op.name)
        op = op.cpu_parent
    return ">".join(port[-3:]) or "?", ">".join(ops) or e.name


def _by_origin(host_ev, steps):
    """Device time, kernels, device-to-device copies and memsets per step,
    by the port function and host op that launched them (eager mode: a graph
    replay has no host op per kernel). Only the kernels of aten ops and of
    `_labelled` ranges (the port's own kernels launch inside them) count:
    the profiler also lists kernels under its overhead records ("Command
    Buffer Full" when the launch queue is full), and those kernels are
    already counted under the op that launched them (a profiled zamba2-2.7b
    prefill on an H100 attributed 507 ms against 397 ms of device work
    with them)."""
    rows = collections.defaultdict(lambda: dict(device_ms=0.0, kernels=0,
                                                copies=0, memsets=0))
    for e in host_ev:
        if not (e.name.startswith("aten::") or e.name in _LABELS):
            continue
        for k in getattr(e, "kernels", None) or ():
            r = rows[_origin(e, _LABELS)]
            r["device_ms"] += k.duration / 1e3 / steps
            if k.name.startswith("Memcpy DtoD"):
                r["copies"] += 1 / steps
            elif k.name.startswith("Memset"):
                r["memsets"] += 1 / steps
            else:
                r["kernels"] += 1 / steps
    return {f"{port} | {ops}": r for (port, ops), r in rows.items()}


def trace_serve(srv, params, reqs, starts, by_origin=False):
    """Serves the same requests again under torch.profiler over windows
    TRACE_FROM - 1 (which warms it up) to TRACE_FROM + 2, and reads windows
    TRACE_FROM and TRACE_FROM + 1. Host events are taken between the marks
    set at those windows' starts; device events on the device's own clock,
    between the device-to-host copies that close windows TRACE_FROM - 1
    and TRACE_FROM + 1 (each window's one sync), since the profiler's host
    and device clocks are not aligned closely enough to cut the device
    timeline at a host mark. The device's busy share is the union of those
    device intervals over the same two windows' wall time in the
    unprofiled run (`starts`). With `by_origin` (eager mode) the port's
    window functions are labelled (`_labelled`), and the device work is
    also summed by the function and host op that launched it
    (`_by_origin`). A trace that is not whole (`trace_events`), or that
    lacks one of the four windows' closing copies, is taken again by
    serving the requests again, up to PROFILES times."""
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function
    if len(starts) < TRACE_FROM + 4:
        raise AssertionError(f"serve ran {len(starts)} windows, too few to "
                             "trace")
    cpu_t = torch.autograd.DeviceType.CPU
    upload = srv._upload
    for attempt in range(1, PROFILES + 1):
        prof = profile(activities=[ProfilerActivity.CPU,
                                   ProfilerActivity.CUDA])
        n = [0]

        def traced(host):
            i = n[0]
            n[0] += 1
            if i == TRACE_FROM - 1:
                prof.start()
                open_trace()
            elif i == TRACE_FROM + 3:
                close_trace()
                prof.stop()
            if i in (TRACE_FROM, TRACE_FROM + 2):
                with record_function(f"window_start_{i}"):
                    pass
            return upload(host)
        srv._upload = traced
        try:
            with _labelled() if by_origin else contextlib.nullcontext():
                srv.serve(params, reqs)
        finally:
            del srv._upload
        events, ok = trace_events(prof)
        closes = sorted((e.time_range for e in events
                         if e.device_type != cpu_t
                         and e.name.startswith("Memcpy DtoH")),
                        key=lambda r: r.start)
        if ok and len(closes) == 4:
            break
        log(f"serve trace {attempt} of at most {PROFILES}: {len(closes)} "
            "device-to-host copies in the 4 traced windows"
            + ("" if ok else ", and spin kernels of its own lost")
            + ": serving again under the profiler")
    if len(closes) != 4:
        raise AssertionError(f"{len(closes)} device-to-host copies in the "
                             "4 traced windows, want one per window")
    wall_us = (starts[TRACE_FROM + 2] - starts[TRACE_FROM]) * 1e6
    mark = {e.name: e.time_range.start for e in events
            if e.device_type == cpu_t and e.name.startswith("window_start_")}
    lo = mark[f"window_start_{TRACE_FROM}"]
    hi = mark[f"window_start_{TRACE_FROM + 2}"]
    host_ev = [e for e in events if e.device_type == cpu_t
               and lo <= e.time_range.start < hi]
    d_lo, d_hi = closes[0].end, closes[2].end
    # the device timeline also holds a span per record_function range
    # (`_labelled`'s): those are annotations, not device work
    dev = [e for e in events if e.device_type != cpu_t
           and not getattr(e, "is_user_annotation", False)
           and e.name not in _LABELS
           and d_lo <= e.time_range.start < d_hi]
    kernels = [e for e in dev if not e.name.startswith(("Memcpy", "Memset"))]
    if not kernels:
        raise AssertionError("the profiler recorded no device activity")
    busy_us = _busy_us([(e.time_range.start, e.time_range.end)
                        for e in dev])
    syncs = collections.Counter(e.name for e in host_ev
                                if "Synchronize" in e.name)
    copies = collections.Counter(e.name for e in dev
                                 if e.name.startswith(("Memcpy", "Memset")))
    by_name = collections.defaultdict(float)
    for e in kernels:
        by_name[e.name] += e.time_range.elapsed_us()
    hades = {}
    for kname, parts in HADES_KERNELS.items():
        us = sum(v for k, v in by_name.items() if any(p in k for p in parts))
        calls = sum(parts[0] in e.name for e in kernels)
        hades[kname] = dict(launches=calls,
                            device_ms_per_launch=us / 1e3 / max(calls, 1))
        if kname == "paged_attention":
            hades[kname]["combine_launches"] = sum(
                parts[1] in e.name for e in kernels)
    steps = 2 * srv.cfg.collect_every
    pa = hades["paged_attention"]
    if not pa["launches"] == pa["combine_launches"] == \
            steps * srv.kv_cfg.num_layers:
        raise AssertionError(f"the traced range holds {hades} launches, "
                             "not one paged_attention split and one combine "
                             f"per layer of {steps} steps")
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]
    res = dict(windows=[TRACE_FROM, TRACE_FROM + 1], steps=steps,
               wall_ms_per_step=wall_us / 1e3 / steps,
               device_busy_ms_per_step=busy_us / 1e3 / steps,
               device_idle_share=1 - busy_us / wall_us,
               kernels_per_step=len(kernels) / steps,
               host_syncs_per_window={k: v / 2 for k, v in syncs.items()},
               copies_per_window={k: v / 2 for k, v in copies.items()},
               memsets_per_window=sum(v for k, v in copies.items()
                                      if k.startswith("Memset")) / 2,
               hades_kernels=hades,
               top_kernels_ms_per_step={k[:120]: v / 1e3 / steps
                                        for k, v in top})
    log(f"serve trace (windows {TRACE_FROM}-{TRACE_FROM + 1}): "
        f"{res['wall_ms_per_step']:.1f} ms/step unprofiled wall, device "
        f"busy {res['device_busy_ms_per_step']:.2f} ms/step, idle share "
        f"{res['device_idle_share']:.3f}, {res['kernels_per_step']:.0f} "
        f"kernels per step, host syncs per window "
        f"{res['host_syncs_per_window']}, copies and memsets per window "
        f"{res['copies_per_window']}")
    for kname, h in hades.items():
        log(f"  {kname}: {h['launches']} launches, "
            f"{h['device_ms_per_launch']:.5f} ms device per launch"
            + (" (split and combine kernels together)"
               if kname == "paged_attention" else ""))
    for k, v in top:
        log(f"  {v / 1e3 / steps:9.4f} ms/step  {k[:100]}")
    if by_origin:
        rows = _by_origin(host_ev, steps)
        res["by_origin_per_step"] = rows
        for key, order in (("device_ms", "device time"),
                           ("copies", "device-to-device copies"),
                           ("memsets", "memsets")):
            log(f"  by launching function and op, {order} per step:")
            for name, r in sorted(rows.items(),
                                  key=lambda kv: -kv[1][key])[:12]:
                if r[key]:
                    log(f"    {r[key]:9.4f}  {name[:110]}  ({r['kernels']:.1f}"
                        f" kernels, {r['copies']:.1f} copies, "
                        f"{r['memsets']:.2f} memsets)")
    return res


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    elif isinstance(tree, list):
        for v in tree:
            yield from _leaves(v)
    else:
        yield tree


# ---------------------------------------------------------------------------
# phase 6: kernel path against plain path on the card
# ---------------------------------------------------------------------------
@contextlib.contextmanager
def _routing(record=None, pinned=None, limit=None):
    """Every MoE routing decision (`moe._route`: gates, top-k weights,
    top-k experts), in call order: appended to `record` (the first `limit`
    calls), or, with `pinned`, the i-th call's experts replaced by those of
    pinned[i % len(pinned)] and its weights re-taken from the call's own
    gates, so that one path takes another's top-k decisions. The pinned
    experts are device tensors, which a captured graph reads as they are."""
    import torch
    from repro_torch.models import moe
    route, n = moe._route, [0]

    def wrapped(p, xf, k):
        gates, w, e = route(p, xf, k)
        if pinned is not None:
            e = pinned[n[0] % len(pinned)][2]
            w = torch.gather(gates, 1, e)
            w = w / w.sum(-1, keepdim=True)
        elif record is not None and (limit is None or n[0] < limit):
            record.append((gates.clone(), w.clone(), e.clone()))
        n[0] += 1
        return gates, w, e
    with mock.patch.object(moe, "_route", wrapped):
        yield


def _flips(rec, plain, k, layers):
    """Routing flips between two recordings of the same decode calls (in
    call order: step by step, layer by layer): the plain path's gap between
    its k-th and (k+1)-th gates at each (call, token) whose expert sets
    differ, split into first-order flips (no flip of the token's lane at an
    earlier layer so far in the window, so its router input differs by
    rounding only) and later ones, and the median gap over all."""
    import torch
    first, later, gaps = [], [], []
    lowest = None       # per lane, the lowest layer that has flipped so far
    for i, ((_, _, e), (g, _, ep)) in enumerate(zip(rec, plain)):
        layer = i % layers
        flip = (e.sort(-1).values != ep.sort(-1).values).any(-1)
        if lowest is None:
            lowest = torch.full_like(flip, layers, dtype=torch.int64)
        top = g.sort(-1, descending=True).values
        gap = top[:, k - 1] - top[:, k]
        clean = lowest >= layer
        first += gap[flip & clean].tolist()
        later += gap[flip & ~clean].tolist()
        lowest = torch.where(flip, lowest.clamp(max=layer), lowest)
        gaps.append(gap)
    return first, later, torch.cat(gaps).median().item()


def _paged_attention_f64(q, k_pages, v_pages, block_tables, seq_lens):
    """`ref.paged_attention` in float64, the output rounded to q's dtype
    once: the plain version with less rounding inside, whose serve window
    measures how far rounding alone moves the plain path's logits."""
    import torch
    from repro_torch.models.attention import _expand_kv
    b, h, d = q.shape
    n_slots, bt, kv, _ = k_pages.shape
    mb = block_tables.shape[1]
    safe = block_tables.clamp(0, n_slots - 1).long()
    k = _expand_kv(k_pages[safe].reshape(b, mb * bt, kv, d).double(), h // kv)
    v = _expand_kv(v_pages[safe].reshape(b, mb * bt, kv, d).double(), h // kv)
    pos = torch.arange(mb * bt, device=q.device)[None]
    valid = (pos < seq_lens[:, None]) & \
        torch.repeat_interleave(block_tables >= 0, bt, dim=1)
    scores = torch.einsum("bhd,bthd->bht", q.double(), k) * d ** -0.5
    scores = torch.where(valid[:, None], scores, -torch.inf)
    out = torch.einsum("bht,bthd->bhd", torch.softmax(scores, -1), v)
    out = torch.where(valid.any(1)[:, None, None], out, 0)
    touched = (torch.arange(mb, device=q.device)[None] * bt
               < seq_lens[:, None]) & (block_tables >= 0)
    return out.to(q.dtype), touched


def kernel_vs_plain(dev, arch="chatglm3-6b", layers=2):
    """A teacher-forced serve window of `arch` at full width and `layers`
    layers, the kernel path (a graph replay) against the plain path (op by
    op, the kernels' plain versions patched in): pool metadata and reports
    exactly, logits within 5e-2, rows migrated.

    An MoE config's top-k routing is a discontinuous function of its input:
    where a token's k-th and (k+1)-th gates lie within the rounding gap of
    the two paths' bf16 attention outputs, they pick different experts,
    and that token's logits (and the K/V of the layers after) part by far
    more than rounding. So the kernel path runs twice: free, with its
    routing recorded in its first (eager) window, against the plain path's
    (the flips and the gate gaps at them printed; the pool metadata and
    reports must still be identical, they do not depend on the values; a
    first-order flip, see `_flips`, at a gap wider than ROUTING_TIE_GAP
    fails); then with its expert choices pinned to the plain path's
    (`_routing`), gated. Any difference between two bf16 paths grows, over
    the bf16 roundings of the layers after it, into logit differences of a
    few hundredths, so the MoE gate is set by a third run, the plain path
    with its attention in float64 (`_paged_attention_f64`, pinned to the
    same routing): its logits' distance from the plain path's is the
    rounding floor, and the kernel path's logits must lie within 5e-2 plus
    that floor of the plain path's. Whether they lie within 5e-2 is
    reported beside it."""
    import dataclasses
    import torch
    from repro_torch.configs import get_config
    from repro_torch.core import engine as eng
    from repro_torch.kernels import ops, ref
    from repro_torch.models.model import Model
    from repro_torch.runtime.server import Server, ServerConfig
    cfg = dataclasses.replace(get_config(arch), num_layers=layers)
    model = Model(cfg, device="cuda")
    params = model.init(torch.Generator(device=dev).manual_seed(1))
    forced = np.random.default_rng(1).integers(
        0, cfg.vocab_size, (SERVE["batch"], 5 * SERVE["collect_every"]))
    n_route = forced.shape[1] * layers          # routing calls a window

    def run(eager, **routing):
        """The kernel path replays the window's graph: a first call
        captures it, `reset` starts the pool afresh, and the second call,
        the one compared, is a replay. The plain path runs op by op."""
        srv = Server(model, ServerConfig(**SERVE))
        srv._eager = eager
        with _routing(limit=n_route, **routing):
            if not eager:
                srv.decode_window(params, forced)
                srv.reset()
            logits, _, reps = srv.decode_window(params, forced)
        torch.cuda.synchronize()
        if srv.replays != int(not eager):
            raise AssertionError(f"{srv.replays} replays in the "
                                 f"{'plain' if eager else 'kernel'} path")
        return _flat(srv.state), logits, eng.window_reports(reps)

    def check_meta(flat_k, reps_k):
        for k in flat_k:
            if not k.endswith("data") and not torch.equal(flat_k[k],
                                                          flat_p[k]):
                raise AssertionError(f"{arch}: pool metadata differs at {k}")
        if reps_k != reps_p:
            raise AssertionError(f"{arch}: collect reports differ")

    plain_routing, routing = [], []
    with mock.patch.multiple(ops, paged_attention=ref.paged_attention,
                             access_scan=ref.access_scan,
                             migrate=ref.migrate):
        flat_p, logits_p, reps_p = run(eager=True, record=plain_routing)
    flat_k, logits_k, reps_k = run(eager=False, record=routing)
    check_meta(flat_k, reps_k)
    top = logits_p.abs().max().item()
    res = dict(layers=layers, max_abs_logit=top)
    if cfg.num_experts:
        first, later, median_gap = _flips(routing, plain_routing,
                                          cfg.experts_per_token, layers)
        free = (logits_k - logits_p).abs()
        res["free"] = dict(logits_max_abs_err=free.max().item(),
                           token_rows_over_5e_2=int(
                               (free >= 5e-2).any(-1).sum()),
                           routing_flips=len(first) + len(later),
                           gate_gaps_at_first_order_flips=first,
                           gate_gaps_at_later_flips=later,
                           median_gate_gap=median_gap)
        log(f"{arch} kernel path vs plain path, routing free: logits max "
            f"|err| {res['free']['logits_max_abs_err']:.3g} "
            f"({res['free']['token_rows_over_5e_2']} token rows >= 5e-2); "
            f"{len(first) + len(later)} routing flips of "
            f"{n_route * SERVE['batch']} token-layers, where the plain "
            f"path's k-th and (k+1)-th gates lay "
            f"{[float(f'{g:.3g}') for g in first]} apart at first-order "
            f"flips (<= {ROUTING_TIE_GAP:g}) and "
            f"{[float(f'{g:.3g}') for g in later]} at later ones (median "
            f"gap over all {median_gap:.3g}); pool metadata and reports "
            "identical")
        if any(gap > ROUTING_TIE_GAP for gap in first):
            raise AssertionError(f"{arch}: a routing flip at a gate gap "
                                 f"wider than {ROUTING_TIE_GAP:g}: {first}")
        flat_k, logits_k, reps_k = run(eager=False, pinned=plain_routing)
        check_meta(flat_k, reps_k)
    diff = (logits_k - logits_p).abs()
    err = diff.max().item()
    tol = 5e-2
    if cfg.num_experts:
        with mock.patch.multiple(ops, paged_attention=_paged_attention_f64,
                                 access_scan=ref.access_scan,
                                 migrate=ref.migrate):
            flat_f, logits_f, reps_f = run(eager=True, pinned=plain_routing)
        check_meta(flat_f, reps_f)
        floor = (logits_f - logits_p).abs()
        res["rounding_floor"] = dict(
            logits_max_abs_err=floor.max().item(),
            logits_over_5e_2=int((floor >= 5e-2).sum()),
            kernel_vs_f64_max_abs_err=(logits_k - logits_f).abs().max()
            .item())
        res["within_5e_2"] = err < 5e-2
        tol = 5e-2 + floor.max().item()
        log(f"{arch} rounding floor: the plain path with float64 attention "
            f"vs the plain path, logits max |err| "
            f"{res['rounding_floor']['logits_max_abs_err']:.3g} "
            f"({res['rounding_floor']['logits_over_5e_2']} logits >= 5e-2);"
            f" the kernel path vs the float64 one "
            f"{res['rounding_floor']['kernel_vs_f64_max_abs_err']:.3g}")
    data_err = (flat_k["pool/data"].float()
                - flat_p["pool/data"].float()).abs().max().item()
    moved = sum(r["moved_to_hot"] + r["moved_to_cold"] for r in reps_k)
    log(f"{arch} kernel path (a graph replay) vs plain path ({layers} "
        f"layers, full width, {forced.shape[1]} teacher-forced steps, "
        f"{moved:.0f} rows migrated"
        + (", routing pinned to the plain path's" if cfg.num_experts else "")
        + f"): pool metadata and reports identical, logits max |err| "
        f"{err:.3g} ("
        + (f"<= {tol:.3g}, 5e-2 plus the rounding floor" if cfg.num_experts
           else f"< {tol:.3g}")
        + f"; {int((diff >= 5e-2).sum())} logits >= 5e-2, max |logit| "
        f"{top:.3g}), pool data max |err| {data_err:.3g}")
    if not (err <= tol if cfg.num_experts else err < tol):
        raise AssertionError(f"{arch}: logits differ by {err}")
    if moved <= 0:
        raise AssertionError(f"{arch}: the comparison window migrated "
                             "nothing")
    return dict(res, logits_max_abs_err=err, limit=tol,
                pool_data_max_abs_err=data_err, rows_migrated=moved,
                routing_pinned=bool(cfg.num_experts))


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}/"))
        else:
            out[f"{prefix}{k}"] = v
    return out


def _prompts(cfg, dev, seed, b=PREFILL_B, s=PREFILL_S):
    """A prefill batch of b x s positions from numpy's seeded generator:
    tokens [b, s]; for a VLM, extra_embeds [b, P, D] (P = vlm_patches(s),
    in the model's dtype) and s - P tokens; for an encoder-decoder also
    enc_embeds [b, S_enc, D] fp32 (the JAX package's batch; embeddings
    N(0, 1) x 0.02, as `Model.make_inputs` draws them)."""
    import torch
    from repro_torch.models.model import vlm_patches
    rng = np.random.default_rng(seed)
    p = vlm_patches(s) if cfg.frontend == "vision" else 0
    batch = {"tokens": torch.from_numpy(
        rng.integers(0, cfg.vocab_size, (b, s - p))).to(dev)}

    def embeds(n, dtype):
        x = rng.standard_normal((b, n, cfg.d_model), np.float32) * 0.02
        return torch.from_numpy(x).to(dev, dtype)
    if p:
        batch["extra_embeds"] = embeds(p, getattr(torch, cfg.dtype))
    if cfg.is_encoder_decoder:
        batch["enc_embeds"] = embeds(cfg.encoder_seq_len, torch.float32)
    return batch


def prefill_flash_vs_blockwise(dev, arch="chatglm3-6b", layers=2):
    """attn_impl="flash" (the kernel) against "blockwise" (plain PyTorch)
    on the same weights and prompts, `layers` layers at full width (a
    hybrid config: whole groups, each shared block one flash launch), in
    float32 (fp32 products: TF32 off) and in the model's bfloat16. The float32
    logits must agree within 5e-2. In bfloat16 the two attentions' fp32
    sums round to bf16 outputs one ulp apart here and there, the gap
    carries through the layers, and the logits come out of a bf16 product
    rounded to 8 significant bits, so the largest of 2 x 4096 x 65024
    logits (|x| near 8, where one ulp is 0.0625) can differ by more than
    5e-2 without a fault: there the logits must agree within two bf16
    ulps of the largest logit (2**-6 * max|x|), the bound the CPU tests
    use for bf16 caches and hiddens. An MoE config's flash prefill runs
    twice, as in `kernel_vs_plain`: free (its logits' gap and whether the
    per-layer expert counts match are printed) and with its expert
    choices pinned to the blockwise path's, which is gated."""
    import torch
    from repro_torch.kernels import ops
    from repro_torch.models.model import Model
    torch.backends.cuda.matmul.allow_tf32 = False
    out = dict(layers=layers, batch=PREFILL_B, seq_len=PREFILL_S)
    for dtype in ("float32", "bfloat16"):
        cfg = _cut(arch, layers=layers, dtype=dtype)
        flash = Model(cfg, attn_impl="flash", device="cuda")
        blockwise = Model(cfg, attn_impl="blockwise", device="cuda")
        params = flash.init(torch.Generator(device=dev).manual_seed(2))
        batch = _prompts(cfg, dev, seed=1)
        res, msg = {}, ""
        with torch.inference_mode():
            n0 = ops.launches["flash_attention"]
            plain_routing = []
            with _routing(record=plain_routing):
                lb, aux_b = blockwise.forward(params, batch)
            lf, aux_f = flash.forward(params, batch)
            if cfg.num_experts:
                res["free"] = dict(
                    logits_max_abs_err=(lf - lb).abs().max().item(),
                    expert_counts_equal=torch.equal(
                        aux_f["expert_counts_per_layer"],
                        aux_b["expert_counts_per_layer"]))
                msg = (f"; routing free: logits max |err| "
                       f"{res['free']['logits_max_abs_err']:.3g}, per-layer "
                       f"expert counts equal "
                       f"{res['free']['expert_counts_equal']}; gated: the "
                       "flash path with the blockwise path's expert choices")
                del lf, aux_f
                with _routing(pinned=plain_routing):
                    lf, aux_f = flash.forward(params, batch)
            torch.cuda.synchronize()
            n = ops.launches["flash_attention"] - n0
            diff = (lf - lb).abs()
            err = diff.max().item()
            over = int((diff >= 5e-2).sum())
            top = lb.abs().max().item()
        del params, lf, lb, diff, aux_f, aux_b, plain_routing
        tol = 5e-2 if dtype == "float32" else 2 ** -6 * top
        log(f"{arch} prefill flash vs blockwise ({dtype}, {layers} layers, "
            f"full width, B={PREFILL_B} S={PREFILL_S}): logits max |err| "
            f"{err:.3g} (< {tol:.3g}), {over} logits >= 5e-2 apart, max |logit| "
            f"{top:.3g}; {n} flash_attention launches{msg}")
        runs = 2 if cfg.num_experts else 1
        if n != runs * _n_blocks(cfg, "attn"):
            raise AssertionError(f"{n} flash_attention launches in {runs} "
                                 f"{layers}-layer prefill(s)")
        if not err < tol:
            raise AssertionError(f"{dtype} prefill logits differ by {err}")
        out[dtype] = dict(res, logits_max_abs_err=err, limit=tol,
                          logits_over_5e_2=over, max_abs_logit=top)
    torch.cuda.empty_cache()
    return out


def _cut(arch, layers=None, dtype=None):
    """`arch` at full width; depth cut to its first `layers` blocks if
    given (a hybrid config to whole groups, an encoder-decoder's encoder
    to as many layers)."""
    import dataclasses
    from repro_torch.configs import get_config
    cfg = get_config(arch)
    if layers is not None:
        cfg = dataclasses.replace(
            cfg, num_layers=layers, block_pattern=cfg.block_pattern[:layers],
            num_encoder_layers=layers if cfg.is_encoder_decoder else 0)
    return cfg if dtype is None else dataclasses.replace(cfg, dtype=dtype)


def _n_blocks(cfg, kind) -> int:
    """The config's mamba blocks (kind "ssm": mamba1 or mamba2, one
    mamba_scan launch each) or attention blocks (kind "attn": a layer, an
    encoder layer or an occurrence of the shared block, one
    flash_attention launch each)."""
    from repro_torch.configs import base
    kinds = {"ssm": (base.MAMBA1, base.MAMBA2),
             "attn": (base.ATTN, base.SHARED_ATTN)}[kind]
    enc = cfg.num_encoder_layers if kind == "attn" and \
        cfg.is_encoder_decoder else 0
    return enc + sum(k in kinds for k in cfg.blocks)


def _decode_logits(model, params, toks, enc_out=None):
    """Teacher-forced decode of toks [B, S] from a fresh state (over an
    encoder-decoder's enc_out): [B, S, V]."""
    import torch
    state = model.init_decode_state(toks.shape[0], toks.shape[1],
                                    enc_out=enc_out)
    out = []
    for t in range(toks.shape[1]):
        lg, state = model.decode_step(params, state, toks[:, t])
        out.append(lg)
    return torch.stack(out, 1)


def mamba_kernel_vs_plain(dev, arch="falcon-mamba-7b", layers=2,
                          attn_impl="blockwise"):
    """`arch` at `layers` layers and full width, B=2 x S=4096: the prefill
    with the mamba_scan kernel (twice) against the same call with its
    plain version patched in, in float32 (TF32 off) and bfloat16. The
    kernel and its plain version agree bit for bit, so the kernel-vs-plain
    gap may be no larger than the gap between two kernel runs (0 unless a
    library call around them is not deterministic). In float32 the
    teacher-forced decode of the first 64 tokens must also reproduce their
    prefill within 1e-3."""
    import torch
    from repro_torch.kernels import ops, ref
    from repro_torch.models.model import Model
    torch.backends.cuda.matmul.allow_tf32 = False
    out = dict(layers=layers, batch=PREFILL_B, seq_len=PREFILL_S)
    for dtype in ("float32", "bfloat16"):
        cfg = _cut(arch, layers=layers, dtype=dtype)
        model = Model(cfg, attn_impl=attn_impl, device="cuda")
        params = model.init(torch.Generator(device=dev).manual_seed(3))
        batch = _prompts(cfg, dev, seed=2)
        with torch.inference_mode():
            n0 = ops.launches["mamba_scan"]
            k1 = model.prefill(params, batch)
            k2 = model.prefill(params, batch)
            n = ops.launches["mamba_scan"] - n0
            with mock.patch.object(ops, "mamba_scan", ref.mamba_scan):
                plain = model.prefill(params, batch)
            torch.cuda.synchronize()
            kk = (k1 - k2).abs().max().item()
            kp = (k1 - plain).abs().max().item()
            top = plain.abs().max().item()
            del k2, plain
            res = dict(kernel_vs_plain=kp, kernel_vs_kernel=kk,
                       max_abs_logit=top)
            msg = ""
            if dtype == "float32":
                toks = batch["tokens"][:, :DRIFT_S]
                dec = _decode_logits(model, params, toks)
                pre = model.prefill(params, {"tokens": toks})
                res["decode_vs_prefill"] = (dec - pre).abs().max().item()
                msg = (f"; decode vs prefill of B={PREFILL_B} x {DRIFT_S} "
                       f"tokens {res['decode_vs_prefill']:.3g} (< 1e-3)")
        del params, k1
        log(f"{arch} prefill kernel vs plain ({dtype}, {layers} layers, "
            f"full width, B={PREFILL_B} S={PREFILL_S}): logits max |err| "
            f"{kp:.3g}, kernel vs kernel {kk:.3g}, max |logit| {top:.3g}; "
            f"{n} mamba_scan launches{msg}")
        if n != 2 * _n_blocks(cfg, "ssm"):
            raise AssertionError(f"{n} mamba_scan launches in two "
                                 f"{layers}-layer prefills")
        if not kp <= kk:
            raise AssertionError(f"{dtype}: kernel vs plain {kp} exceeds "
                                 f"kernel vs kernel {kk}")
        if not res.get("decode_vs_prefill", 0.0) < 1e-3:
            raise AssertionError(f"decode vs prefill {res}")
        out[dtype] = res
        torch.cuda.empty_cache()
    return out


# ---------------------------------------------------------------------------
# phase 7: the prefill path at full width and depth
# ---------------------------------------------------------------------------
def prefill_full(dev, arch="chatglm3-6b"):
    import torch
    from repro_torch.configs import get_config
    from repro_torch.models.model import Model
    cfg = get_config(arch)
    model = Model(cfg, attn_impl="flash", device="cuda")
    params = model.init(torch.Generator(device=dev).manual_seed(0))
    with torch.inference_mode():
        res = measure_prefill(
            model, params, cfg, dev, {"flash_attention": cfg.num_layers},
            {"flash_attention_wgmma_kernel": cfg.num_layers},
            absent="flash_attention_kernel")
    del params
    torch.cuda.empty_cache()
    return res


def _profiled(fn):
    """Runs fn() under torch.profiler: (its device events, the wall ms of
    that run). A trace that is not whole (`trace_events`) is taken again,
    fn() run again, up to PROFILES times. The idle share is read against
    that wall: the profiler slows the device by some microseconds a
    kernel, so a busy time from the trace can exceed an unprofiled wall."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    for attempt in range(1, PROFILES + 1):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            open_trace()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3
            close_trace()
        events, ok = trace_events(prof)
        dev_ev = [e for e in events
                  if e.device_type == torch.autograd.DeviceType.CUDA]
        if ok:
            break
        log(f"profiled run {attempt} of at most {PROFILES} lost spin "
            f"kernels of its own ({len(dev_ev)} device records): the "
            "profiler dropped records")
    if not dev_ev:
        raise AssertionError("the profiler recorded no device activity")
    return dev_ev, wall_ms


def _only(launches, want):
    """Every port kernel's launches are `want`'s count ({kernel: n}), or 0
    for a kernel it does not name."""
    if {k: v for k, v in launches.items() if v} != \
            {k: n for k, n in want.items() if n}:
        raise AssertionError(f"launches {launches}: want {want} and no "
                             "other kernel")


def measure_prefill(model, params, cfg, dev, want, device_want, absent=None):
    """`Model.prefill` of B=PREFILL_B x S=PREFILL_S prompts: the launch
    counts are reset just before one prefill and read just after (exactly
    `want` = {port kernel: launches}, no other kernel; a flash_attention
    launch on the tensor cores only), its logits must be finite [B, S, V];
    then ms per prefill (median of 3) and one profiled prefill (idle share,
    each kernel's share of device time, top kernels), in which each device
    kernel of `device_want` ({name: launches}) must run as often as it
    says and none named `absent` (a trace that shows fewer, the profiler
    having dropped records, is taken again, up to PROFILES profiled
    prefills)."""
    import torch
    from repro_torch.kernels import ops
    batch = _prompts(cfg, dev, seed=0)
    n_tok = PREFILL_B * PREFILL_S
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launches()
    logits = model.prefill(params, batch)
    torch.cuda.synchronize()
    launches = dict(ops.launches)
    variants = dict(ops.flash_variants)
    shape = tuple(logits.shape)
    finite = bool(torch.isfinite(logits).all())
    del logits
    log(f"{cfg.name} prefill launches: {launches}; flash variants {variants}")
    _only(launches, want)
    if variants["cuda_cores"]:
        raise AssertionError(f"flash variants {variants}: want every launch "
                             "on the tensor cores")
    if shape != (PREFILL_B, PREFILL_S, cfg.vocab_size) or not finite:
        raise AssertionError(f"prefill logits {shape}, finite {finite}")
    walls = []
    for _ in range(3):
        t0 = time.perf_counter()
        model.prefill(params, batch)
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) * 1e3)
    # torch.profiler can drop a burst of device records from a profiled
    # prefill (seen on the H100: 21-115 of 2173-2738, any kernel, one of
    # them a flash launch): a trace short of a kernel of `device_want` is
    # taken again, up to PROFILES times; one with too many, or with
    # `absent`, fails
    for profiles in range(1, PROFILES + 1):
        dev_ev, prof_ms = _profiled(lambda: model.prefill(params, batch))
        mine = {k: [e for e in dev_ev if k in e.name] for k in device_want}
        seen = {k: len(v) for k, v in mine.items()}
        n_absent = sum(absent in e.name for e in dev_ev) if absent else 0
        if seen == device_want or n_absent or any(
                seen[k] > n for k, n in device_want.items()):
            break
        log(f"the profiled prefill shows {seen} of {device_want} "
            f"({len(dev_ev)} device records): the profiler dropped records; "
            "profiling it again")
    if seen != device_want or n_absent:
        raise AssertionError(
            f"the profiled prefill ran {seen} (want {device_want}) and "
            f"{n_absent} {absent} (want 0), in {profiles} profiled "
            "prefill(s)")
    wall = float(np.median(walls))
    total_us = sum(e.time_range.elapsed_us() for e in dev_ev)
    mine_us = {k: sum(e.time_range.elapsed_us() for e in v)
               for k, v in mine.items()}
    busy_us = _busy_us([(e.time_range.start, e.time_range.end)
                        for e in dev_ev])
    by_name = collections.defaultdict(float)
    for e in dev_ev:
        by_name[e.name[:100]] += e.time_range.elapsed_us() / 1e3
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:8]
    res = dict(layers=cfg.num_layers, batch=PREFILL_B, seq_len=PREFILL_S,
               ms_per_prefill=wall, prefill_ms_runs=walls,
               tok_per_s=n_tok / wall * 1e3, profiled_ms=prof_ms,
               device_ms_per_prefill=total_us / 1e3,
               device_busy_ms=busy_us / 1e3,
               device_idle_share=1 - busy_us / 1e3 / prof_ms,
               kernels_profiled=seen, profiles=profiles,
               flash_variants=variants,
               kernels_device_ms={k: v / 1e3 for k, v in mine_us.items()},
               kernels_device_share={k: v / total_us
                                     for k, v in mine_us.items()},
               launches=launches, top_kernels_ms=dict(top),
               kernels_per_prefill=len(dev_ev),
               peak_device_bytes=torch.cuda.max_memory_allocated())
    log(f"prefill: {cfg.name} {cfg.num_layers} layers, B={PREFILL_B} x "
        f"S={PREFILL_S}: {wall:.1f} ms per prefill (runs "
        f"{[round(w, 1) for w in walls]}), {res['tok_per_s']:.0f} tok/s; "
        f"profiled: {prof_ms:.1f} ms, device {total_us / 1e3:.1f} ms, busy "
        f"{busy_us / 1e3:.1f} ms (idle share {res['device_idle_share']:.5f}), "
        + ", ".join(f"{k} {seen[k]} launches {mine_us[k] / 1e3:.1f} ms = "
                    f"{res['kernels_device_share'][k]:.3f}" for k in seen)
        + " of device time; peak device memory "
        f"{res['peak_device_bytes'] / 2**30:.2f} GiB; {len(dev_ev)} device "
        "kernels and copies")
    for k, v in top:
        log(f"  {v:9.3f} ms  {k}")
    return res


# ---------------------------------------------------------------------------
# phase 8: the mamba1 path at full width and depth
# ---------------------------------------------------------------------------
def decode_run(model, params, cfg, dev, prompt_len=DECODE_PROMPT,
               new=DECODE_NEW, enc_out=None):
    """Decode of DECODE_B sequences (over an encoder-decoder's enc_out):
    `prompt_len` teacher-forced tokens, then `new` greedy ones, each
    step's launches counted from 0 (one mamba_scan per mamba block and no
    other kernel: an attention layer's decode launches none); then a
    profiled stretch of 4 more steps for the idle share."""
    import torch
    from repro_torch.kernels import ops
    prompt = torch.from_numpy(np.random.default_rng(1).integers(
        0, cfg.vocab_size, (DECODE_B, prompt_len))).to(dev)
    state = model.init_decode_state(DECODE_B, prompt_len + new + 4,
                                    enc_out=enc_out)
    tok, per_step = prompt[:, 0], []
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for t in range(prompt_len + new):
        ops.reset_launches()
        logits, state = model.decode_step(params, state, tok)
        per_step.append(dict(ops.launches))
        tok = prompt[:, t + 1] if t + 1 < prompt_len else logits.argmax(-1)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    want = {"mamba_scan": _n_blocks(cfg, "ssm")}
    for launches in per_step:
        _only(launches, want)
    steps = len(per_step)
    if not bool(torch.isfinite(logits).all()):
        raise AssertionError("decode logits are not finite")
    ms_step = wall / steps * 1e3

    def stretch():
        nonlocal state, tok
        for _ in range(4):
            logits, state = model.decode_step(params, state, tok)
            tok = logits.argmax(-1)
    dev_ev, prof_ms = _profiled(stretch)
    busy_us = _busy_us([(e.time_range.start, e.time_range.end)
                        for e in dev_ev])
    res = dict(batch=DECODE_B, steps=steps, ms_per_step=ms_step,
               tok_per_s=DECODE_B * steps / wall,
               launches_per_step=per_step[0],
               profiled_ms_per_step=prof_ms / 4,
               device_busy_ms_per_step=busy_us / 1e3 / 4,
               device_idle_share=1 - busy_us / 1e3 / prof_ms,
               kernels_per_step=len(dev_ev) / 4)
    log(f"{cfg.name} decode: B={DECODE_B}, {prompt_len} teacher-forced "
        f"+ {new} greedy steps, {want['mamba_scan']} mamba_scan "
        f"launches and no other port kernel each: {ms_step:.2f} ms per "
        "step, "
        f"{res['tok_per_s']:.1f} tok/s; "
        f"profiled 4 steps: {res['profiled_ms_per_step']:.2f} ms per step, "
        f"device busy {res['device_busy_ms_per_step']:.3f} ms of it, idle "
        f"share {res['device_idle_share']:.4f}, "
        f"{res['kernels_per_step']:.0f} kernels per step")
    return res


def mamba_drift(model, params, cfg, dev):
    """bf16 prefill against teacher-forced decode of B=2 x DRIFT_S tokens
    at full depth (reported, not gated)."""
    import torch
    toks = torch.from_numpy(np.random.default_rng(2).integers(
        0, cfg.vocab_size, (PREFILL_B, DRIFT_S))).to(dev)
    pre = model.prefill(params, {"tokens": toks})
    dec = _decode_logits(model, params, toks)
    err = (dec - pre).abs().max().item()
    agree = (dec.argmax(-1) == pre.argmax(-1)).float().mean().item()
    top = pre.abs().max().item()
    log(f"{cfg.name} bf16 drift, prefill vs teacher-forced decode (B="
        f"{PREFILL_B} x {DRIFT_S}, {cfg.num_layers} layers): max |dlogit| "
        f"{err:.4g}, max |logit| {top:.4g}, argmax agreement {agree:.4f}")
    return dict(max_abs_dlogit=err, max_abs_logit=top, argmax_agreement=agree)


def mamba_full(dev):
    import torch
    from repro_torch.models.model import Model
    cfg = _cut("falcon-mamba-7b")
    model = Model(cfg, device="cuda")
    t0 = time.perf_counter()
    params = model.init(torch.Generator(device=dev).manual_seed(0))
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in _leaves(params))
    log(f"falcon-mamba-7b: {cfg.num_layers} layers, d_model {cfg.d_model}, "
        f"{n_params / 1e9:.3f} B params ({cfg.dtype}), init "
        f"{time.perf_counter() - t0:.1f} s")
    with torch.inference_mode():
        res = dict(params=n_params, prefill=measure_prefill(
            model, params, cfg, dev, {"mamba_scan": cfg.num_layers},
            {"mamba_scan_kernel": cfg.num_layers}))
        res["decode"] = decode_run(model, params, cfg, dev)
        res["drift_bf16"] = mamba_drift(model, params, cfg, dev)
    del params
    torch.cuda.empty_cache()
    return res


# ---------------------------------------------------------------------------
# phase 9: the MoE path (olmoe-1b-7b, mixtral-8x7b)
# ---------------------------------------------------------------------------
def moe_path(dev):
    """(a) olmoe-1b-7b served at full width and depth, graph then eager
    (phases 4-5's gates, `serve_full`); (b) its flash prefill at B=2 x
    S=4096 (phase 7's gates, `prefill_full`); (c) at full width and 2
    layers, a teacher-forced serve window of olmoe and of mixtral-8x7b
    with the kernel path against the plain path, and olmoe's prefill with
    flash against blockwise (phase 6's gates)."""
    t = [time.perf_counter()]
    launches, serve, steps = serve_full(dev, "olmoe-1b-7b")
    t.append(time.perf_counter())
    prefill = prefill_full(dev, "olmoe-1b-7b")
    t.append(time.perf_counter())
    vs_plain = {arch: kernel_vs_plain(dev, arch)
                for arch in ("olmoe-1b-7b", "mixtral-8x7b")}
    vs_plain["olmoe-1b-7b"]["prefill"] = prefill_flash_vs_blockwise(
        dev, "olmoe-1b-7b")
    t.append(time.perf_counter())
    log(f"phase 9 (a) {t[1] - t[0]:.1f} s, (b) {t[2] - t[1]:.1f} s, (c) "
        f"{t[3] - t[2]:.1f} s")
    return dict(serve=serve, prefill=prefill, kernel_vs_plain=vs_plain,
                launches={k: launches[k] for k in HADES_KERNELS},
                launches_per_step={k: launches[k] / steps
                                   for k in HADES_KERNELS},
                flash_launches_per_prefill=prefill["launches"][
                    "flash_attention"])


# ---------------------------------------------------------------------------
# phase 10: the object engine on a 2^20-slot YCSB-B pool
# ---------------------------------------------------------------------------
# make_config(699050, 256, sb_slots=64, page_slots=4, slack=1.5): 2^20 slots
# of 1 KiB (a YCSB record of 10 fields x 100 B), 4 KiB pages, 64 KiB
# superblocks; the most slots a table word's 20-bit slot field addresses
ENGINE_POOL = dict(max_objects=699050, slot_words=256, sb_slots=64,
                   page_slots=4, slack=1.5)
YCSB_K, YCSB_EVERY, YCSB_WINDOWS = 4096, 20, 64   # keys a step, steps a window
ENGINE_BUDGET = 16384          # collector moves per direction per window
LOAD_CHUNK = 65536             # ids per alloc step of the load
PLAIN_WINDOWS = 8              # (d): windows on the plain path
PROFILED = range(56, 60)       # (e): the profiled stretch of (b)
PU_WINDOWS = (0, 8, 16, 24, 32, 40, 48, 56, 63)
SIM_WINDOWS = 16               # (f)


def ycsb_windows(n_keys, n_windows, w):
    """YCSB-B on scrambled Zipf keys (theta 0.99) over the first third of
    the ranks (`ZipfianKeys(n_keys, seed=0, active_frac=1/3)`, sampled in
    order): each window 19 read steps and 1 write step (95 % / 5 %) of
    YCSB_K keys. A write step's payload has one row per distinct key
    (numpy seed 1), so a key written twice in a step gets the same bytes
    (which of two writes to one slot lands is not defined on the card)."""
    from repro_torch.data.ycsb import WORKLOADS, ZipfianKeys
    mix = WORKLOADS["B"]
    assert mix.update_frac * YCSB_EVERY == 1
    keys = ZipfianKeys(n_keys, seed=0, active_frac=1 / 3)
    rng = np.random.default_rng(1)
    out = []
    for _ in range(n_windows):
        steps = []
        for s in range(YCSB_EVERY):
            ks = keys.sample(YCSB_K)
            if s < YCSB_EVERY - 1:
                steps.append(("read", ks, None))
                continue
            uniq, inv = np.unique(ks, return_inverse=True)
            rows = rng.standard_normal((len(uniq), w), dtype=np.float32)
            steps.append(("write", ks, rows[inv]))
        out.append(steps)
    return out


def _clone(state):
    import torch
    from torch.utils import _pytree as pytree
    return pytree.tree_map(torch.clone, state)


def _states_equal(a, b) -> list:
    """The leaves of two pool states that differ (every leaf compared)."""
    import torch
    fa, fb = _flat(a), _flat(b)
    if sorted(fa) != sorted(fb):
        return ["<structure>"]
    return [k for k in fa if not torch.equal(fa[k], fb[k])]


@contextlib.contextmanager
def count_syncs():
    """Counts the synchronising CUDA operations inside the block (sync
    debug mode "warn")."""
    import torch
    n = [0]

    def on_warning(message, *args, **kwargs):
        if "synchronizing CUDA operation" in str(message):
            n[0] += 1
    with warnings.catch_warnings():
        warnings.simplefilter("always")
        warnings.showwarning = on_warning
        torch.cuda.set_sync_debug_mode("warn")
        try:
            yield n
        finally:
            torch.cuda.set_sync_debug_mode("default")


def engine_options():
    from repro_torch.core import backend as be
    from repro_torch.core.collector import CollectorConfig
    from repro_torch.core.engine import EngineOptions
    return EngineOptions(collect_every=YCSB_EVERY,
                         backend=be.make("proactive"),
                         collector=CollectorConfig(move_budget=ENGINE_BUDGET))


def engine_load(eng, dev):
    """(a) every id allocated with payloads from a seeded generator on the
    card, LOAD_CHUNK ids an `Engine.step("alloc")`, no collect; then the
    load phase's reset. Returns (state, the payloads as a numpy mirror)."""
    import torch
    from repro_torch.core.frontend import clear_load_phase
    n, w = eng.cfg.max_objects, eng.cfg.slot_words
    g = torch.Generator(device=dev).manual_seed(0)
    mirror = np.empty((n, w), np.float32)
    state = eng.init()
    for lo in range(0, n, LOAD_CHUNK):
        hi = min(lo + LOAD_CHUNK, n)
        vals = torch.randn((hi - lo, w), generator=g, device=dev)
        state, _, _ = eng.step(state, "alloc", torch.arange(
            lo, hi, dtype=torch.int32, device=dev), vals)
        mirror[lo:hi] = vals.cpu().numpy()
    return clear_load_phase(state), mirror


def engine_graph_run(eng, state, windows, dev):
    """(b) every window one `run_window` call on its `make_trace`, in graph
    mode; the launch counts reset just before and read just after; CUDA's
    sync debug mode on inside every call after the first; windows 1 to
    PROFILED.start - 1 timed (wall, no sync between windows), PROFILED
    traced (the as many windows after it when that trace is not whole,
    `trace_events`). Returns (state, per-window read outputs and reports,
    the state after PLAIN_WINDOWS windows, stats)."""
    import torch
    from repro_torch.core import engine as E
    from repro_torch.kernels import ops
    pcfg = eng.cfg
    torch.cuda.synchronize()
    ops.reset_launches()
    outs, reps, syncs, snap = [], [], 0, None
    prof, t, profiled = None, {}, PROFILED
    for wi, steps in enumerate(windows):
        if wi == 1:
            torch.cuda.synchronize()
            t["start"] = time.perf_counter()
        if wi == PROFILED.start:
            torch.cuda.synchronize()
            t["stop"] = time.perf_counter()
        if wi == profiled.start:
            prof = _engine_profile()
        trace = E.make_trace(pcfg, steps, device=dev)
        if wi == 0:
            state, out, rep = eng.run_window(state, trace, 0)
        else:
            with count_syncs() as n:
                state, out, rep = eng.run_window(state, trace,
                                                 wi * YCSB_EVERY)
            syncs += n[0]
        outs.append(out)
        reps.append(rep)
        if wi == PLAIN_WINDOWS - 1:
            snap = _clone(state)
        if wi == profiled.stop - 1:
            close_trace()
            prof.stop()
            events, ok = trace_events(prof)
            later = range(profiled.stop, profiled.stop + len(PROFILED))
            if not ok and later.stop <= len(windows):
                log(f"engine trace of windows {profiled.start}-"
                    f"{profiled.stop - 1} lost spin kernels of its own: "
                    f"profiling windows {later.start}-{later.stop - 1}")
                profiled = later
    torch.cuda.synchronize()
    launches = dict(ops.launches)
    timed = PROFILED.start - 1
    wall = (t["stop"] - t["start"]) / timed
    return state, outs, reps, snap, dict(
        launches=launches, syncs_inside_windows=syncs,
        replays=eng.replays, graphs=len(eng._run._g.graphs),
        ms_per_window=wall * 1e3,
        ops_per_s=YCSB_EVERY * YCSB_K / wall, events=events,
        profiled=profiled)


def _engine_profile():
    from torch.profiler import ProfilerActivity, profile
    prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
    prof.start()
    open_trace()
    return prof


def engine_trace_stats(events, profiled, ms_per_window, moved):
    """(e) from the events of the profiled windows (`profiled`): device
    busy and idle share (against the unprofiled wall per window), kernels
    per window, and access_scan's and migrate's device time per launch
    against their bounds (migrate's from the rows those windows moved)."""
    import torch
    cpu_t = torch.autograd.DeviceType.CPU
    n_win = len(profiled)
    dev = [e for e in events if e.device_type != cpu_t
           and not getattr(e, "is_user_annotation", False)]
    kernels = [e for e in dev if not e.name.startswith(("Memcpy", "Memset"))]
    if not kernels:
        raise AssertionError("the profiler recorded no device activity")
    busy_ms = _busy_us([(e.time_range.start, e.time_range.end)
                        for e in dev]) / 1e3 / n_win
    n, n_sbs = ENGINE_POOL["max_objects"], 16384
    scan_bound = bound(n * 10 + 4 * n_sbs + 8, 20 * n, "int32")[0]
    per = {}
    for kname in ("access_scan", "migrate"):
        parts = HADES_KERNELS[kname]
        us = sum(e.time_range.elapsed_us() for e in kernels
                 if any(p in e.name for p in parts))
        calls = sum(parts[0] in e.name for e in kernels)
        per[kname] = dict(launches=calls,
                          device_ms_per_launch=us / 1e3 / max(calls, 1))
    per["access_scan"]["bound_ms"] = scan_bound
    rows = sum(moved) / n_win
    per["migrate"]["bound_ms"] = bound(
        2 * rows * 1024 + 2 * ENGINE_BUDGET * 9, 0, "fp32")[0]
    per["migrate"]["rows_per_launch"] = rows
    by_name = collections.Counter()
    for e in kernels:
        by_name[e.name[:80]] += e.time_range.elapsed_us() / 1e3 / n_win
    return dict(
        windows=list(profiled), device_busy_ms_per_window=busy_ms,
        device_busy_share=busy_ms / ms_per_window,
        device_idle_share=1 - busy_ms / ms_per_window,
        kernels_per_window=len(kernels) / n_win,
        copies_memsets_per_window=(len(dev) - len(kernels)) / n_win,
        kernels=per, top_ms_per_window=dict(by_name.most_common(8)))


def engine_eager_run(pcfg, opts, state, windows, dev):
    """(c) the same windows op by op through `Hades` (the per-op path: one
    `Engine.step` an op, the collect fused into the closing op) from a
    clone of the loaded state. Returns (Hades, read outputs, last report
    per window, Page Utilization before the closing op of PU_WINDOWS,
    ms per window)."""
    import torch
    from repro_torch.core import Hades
    from repro_torch.core import engine as E
    h = Hades(pcfg, opts, device=dev)
    h.state = state
    outs, reps, pu = [], [], {}
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for wi, steps in enumerate(windows):
        trace = E.make_trace(pcfg, steps, device=dev)
        read = []
        for i, (op, _, _) in enumerate(steps):
            if i == YCSB_EVERY - 1 and wi in PU_WINDOWS:
                pu[wi] = h.page_utilization()
            if op == "read":
                read.append(h.read(trace["ids"][i]))
            else:
                h.write(trace["ids"][i], trace["values"][i])
        outs.append(read)
        reps.append(h.last_report)
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) / len(windows) * 1e3
    return h, outs, reps, pu, ms


def engine_plain_run(pcfg, opts, state, windows, dev):
    """(d) the first PLAIN_WINDOWS windows through `Engine.run_window` op by
    op with access_scan and migrate patched to their plain versions."""
    import torch
    from repro_torch.core import engine as E
    from repro_torch.kernels import ops, ref
    eng = E.Engine(pcfg, opts, device=dev)
    eng._run.eager = True
    ops.reset_launches()
    with mock.patch.multiple(ops, access_scan=ref.access_scan,
                             migrate=ref.migrate):
        for wi, steps in enumerate(windows[:PLAIN_WINDOWS]):
            state, _, _ = eng.run_window(
                state, E.make_trace(pcfg, steps, device=dev),
                wi * YCSB_EVERY)
    torch.cuda.synchronize()
    return state, dict(ops.launches)


def content_check(eng, state, mirror, dev):
    """A read of every id returns the payload last written to it."""
    import torch
    n = eng.cfg.max_objects
    bad = 0
    for lo in range(0, n, LOAD_CHUNK):
        hi = min(lo + LOAD_CHUNK, n)
        state, got, _ = eng.step(state, "read", torch.arange(
            lo, hi, dtype=torch.int32, device=dev))
        bad += int((got.cpu().numpy() != mirror[lo:hi]).any(axis=1).sum())
    return state, bad


def sim_run(dev, windows):
    """(f) SimHeap over the same objects (1 KiB each) and the first
    SIM_WINDOWS windows of the key stream: every step's keys accessed,
    then collect and the backend step (`reactive` under a target of 40 %
    of the footprint, fig 7's)."""
    from repro_torch.core.simheap import SimConfig, SimHeap
    n = ENGINE_POOL["max_objects"]
    cfg = SimConfig(max_objects=n, heap_bytes=1 << 30, backend="reactive",
                    hbm_target_bytes=int(0.4 * n * 1024))
    h = SimHeap(cfg, seed=0, device=dev)
    h.alloc(np.arange(n), np.full(n, 1024))
    t0 = time.perf_counter()
    for steps in windows[:SIM_WINDOWS]:
        for _, ks, _ in steps:
            h.access_objects(ks)
        h.collect()
        h.backend_step()
    return h, time.perf_counter() - t0


def check_engine_kernels(dev, pcfg, migrate_was=None):
    """access_scan and migrate at the engine's shapes, exactly against their
    plain versions, and timed: the table of 699,050 words over 16,384
    superblocks (no histogram); 2 x ENGINE_BUDGET moves of 1 KiB rows (a
    tenth masked) over the [2^20 + 1, 256] fp32 pool, on the hazard,
    disjoint and swap lists (`_migrate_lists`). migrate must take no more
    device time than data[dst] = data[src] on the disjoint list. With
    `migrate_was`
    (built by `_migrate_was`) the earlier migrate kernel is held and timed
    beside it. The full run takes it in phase 3, --engine-only in phase
    10."""
    import torch
    from repro_torch.kernels import ops, ref
    g = torch.Generator().manual_seed(10)
    n = pcfg.max_objects
    table = _random_table(g, n, pcfg.n_slots, dev)
    ct = torch.tensor(3.0, device=dev)
    kw = dict(sb_slots=pcfg.sb_slots, n_sbs=pcfg.n_sbs, with_hist=False)
    if not all(map(torch.equal, ops.access_scan(table, ct, **kw),
                   ref.access_scan(table, ct, **kw))):
        raise AssertionError("access_scan differs at the engine's table")
    scan = timings(lambda: ops.access_scan(table, ct, **kw), 200,
                   lambda: ref.access_scan(table, ct, **kw), 50)
    b_ms, b_by = bound(n * 10 + 4 * pcfg.n_sbs + 8, 20 * n, "int32")
    scan.update(bound_ms=b_ms, bound_by=b_by, max_abs_err=0.0,
                shape=f"table [{n}] int32, n_sbs {pcfg.n_sbs}")
    gd = torch.Generator(device=dev).manual_seed(10)
    mig = _migrate_pool_cases(g, gd, dev, pcfg.n_slots, pcfg.slot_words,
                              torch.float32, ENGINE_BUDGET, "the engine",
                              migrate_was)
    d = mig["disjoint"]
    if d["device_ms"] > d["library_device_ms"]:
        raise AssertionError(
            f"migrate at the engine's disjoint case takes {d['device_ms']:.5f}"
            f" ms device, more than data[dst] = data[src] "
            f"({d['library_device_ms']:.5f})")
    log(f"access_scan at the engine's table: exact; {_fmt(scan)}, bound "
        f"{b_ms:.5f} ms")
    return {"access_scan": scan,
            "migrate": dict(mig["hazard"], disjoint=mig["disjoint"],
                            swap=mig["swap"])}


def engine_pool_config():
    from repro_torch.core import pool as pl
    pcfg = pl.make_config(**ENGINE_POOL)
    if pcfg.n_slots != 1 << 20:
        raise AssertionError(f"{pcfg.n_slots} slots, want 2^20")
    return pcfg


def engine_path(dev, kernels):
    """Phase 10: the object engine on the 2^20-slot YCSB-B pool, steps (a)
    to (f) (see the module docstring); raises if a gate fails. `kernels`:
    `check_engine_kernels`' result, which the full run takes in phase 3,
    before the profiler has traced the long phases in between."""
    import torch
    from repro_torch.core import engine as E
    from repro_torch.core import pool as pl
    from repro_torch.core.frontend import heap_histogram
    t = [time.perf_counter()]
    pcfg = engine_pool_config()
    opts = engine_options()
    windows = ycsb_windows(pcfg.max_objects, YCSB_WINDOWS, pcfg.slot_words)
    eng = E.Engine(pcfg, opts, device=dev)
    state, mirror = engine_load(eng, dev)
    for steps in windows:
        for op, ks, vals in steps:
            if op == "write":
                mirror[ks] = vals
    loaded = _clone(state)
    hist0 = heap_histogram(state)
    t.append(time.perf_counter())
    log(f"engine: pool of {pcfg.n_slots} slots x {pcfg.slot_bytes} B "
        f"({pcfg.n_sbs} superblocks), {pcfg.max_objects} objects loaded "
        f"in {t[1] - t[0]:.1f} s (kernel checks included): {hist0}")

    # (b) graph mode
    state, outs_b, reps_b, snap, graph = engine_graph_run(eng, state,
                                                          windows, dev)
    host_b = [E.window_reports(r) for r in reps_b]
    if any(len(r) != 1 for r in host_b):
        raise AssertionError("a window did not close with one collect")
    host_b = [r[0] for r in host_b]
    moved = [(r["moved_to_hot"], r["moved_to_cold"]) for r in host_b]
    launches = graph["launches"]
    want = {k: (YCSB_WINDOWS if k in ("access_scan", "migrate") else 0)
            for k in launches}
    if launches != want:
        raise AssertionError(f"launches {launches}, want {want}")
    if graph["replays"] != YCSB_WINDOWS - 1 or graph["graphs"] != 1:
        raise AssertionError(f"{graph['replays']} replays of "
                             f"{graph['graphs']} graphs in {YCSB_WINDOWS} "
                             "windows: want every window after the first "
                             "one replay of one graph")
    if graph["syncs_inside_windows"]:
        raise AssertionError(f"{graph['syncs_inside_windows']} host syncs "
                             "inside graph windows")
    if not any(h for h, _ in moved) or not any(c for _, c in moved):
        raise AssertionError(f"no collect moved rows both ways: {moved}")
    events, profiled = graph.pop("events"), graph.pop("profiled")
    trace = engine_trace_stats(events, profiled, graph["ms_per_window"],
                               [h + c for h, c in moved[profiled.start:
                                                        profiled.stop]])
    del events
    if any(trace["kernels"][k]["launches"] != len(profiled)
           for k in ("access_scan", "migrate")):
        raise AssertionError(f"profiled windows: {trace['kernels']}")
    t.append(time.perf_counter())

    # (c) eager against graph
    h, outs_c, reps_c, pu, eager_ms = engine_eager_run(
        pcfg, opts, _clone(loaded), windows, dev)
    bad = [k for k in _states_equal(state, h.state)]
    for wi, (ob, oc) in enumerate(zip(outs_b, outs_c)):
        for i, o in enumerate(oc):
            if not torch.equal(ob[i], o):
                bad.append(f"read output of window {wi} step {i}")
    host_c = [{k: float(v) for k, v in r.items()} for r in reps_c]
    if host_c != host_b:
        bad.append("reports")
    if bad:
        raise AssertionError(f"eager differs from graph: {bad[:8]}")
    del outs_b, outs_c
    t.append(time.perf_counter())

    # (d) kernel path (b) against the plain path
    plain, plain_launches = engine_plain_run(pcfg, opts, loaded,
                                             windows, dev)
    bad = _states_equal(snap, plain)
    if bad or plain_launches["access_scan"] or plain_launches["migrate"]:
        raise AssertionError(f"plain path differs at {bad[:8]} (launches "
                             f"{plain_launches})")
    del plain, snap, loaded
    t.append(time.perf_counter())

    # content, gauges
    final = {"heap_histogram": heap_histogram(state),
             "rss_bytes": float(pl.rss_bytes(pcfg, state)),
             "host_bytes": float(pl.host_bytes(pcfg, state)),
             "total_moves": int(state["total_moves"]),
             "total_faults": int(state["total_faults"]),
             "ciw_threshold": float(state["ciw_threshold"])}
    state, n_bad = content_check(eng, state, mirror, dev)
    if n_bad:
        raise AssertionError(f"{n_bad} of {pcfg.max_objects} objects do "
                             "not read back their last payload")
    del state, h, mirror
    torch.cuda.empty_cache()
    t.append(time.perf_counter())

    # (f) SimHeap, backend on the card and on the CPU
    sims = {d: sim_run(d, windows) for d in (dev, "cpu")}
    (hg, sg), (hc, sc) = sims.values()
    bad = [k for k in ("addr", "heap", "resident", "evict", "referenced")
           if not np.array_equal(getattr(hg, k), getattr(hc, k))]
    if bad or hg.window_log != hc.window_log:
        raise AssertionError(f"SimHeap on the card differs from the CPU at "
                             f"{bad or 'window_log'}")
    t.append(time.perf_counter())

    ops_s = YCSB_EVERY * YCSB_K / (eager_ms / 1e3)
    log(f"engine (b) graph: {graph['ms_per_window']:.3f} ms a window "
        f"({graph['ops_per_s']:.0f} ops/s, windows 1-{PROFILED.start - 1}, "
        f"trace building included), {graph['replays']} replays of "
        f"{graph['graphs']} graph, launches access_scan/migrate "
        f"{YCSB_WINDOWS}/{YCSB_WINDOWS}, {graph['syncs_inside_windows']} "
        f"syncs inside windows; (c) eager (Hades, op by op) "
        f"{eager_ms:.3f} ms a window ({ops_s:.0f} ops/s); identical state, "
        f"reads and reports; (d) plain path identical after "
        f"{PLAIN_WINDOWS} windows")
    log(f"engine moved (to hot, to cold) per window: "
        f"{[(int(a), int(b)) for a, b in moved]}")
    log(f"engine Page Utilization before each listed window's closing "
        f"op: {pu}")
    log(f"engine after {YCSB_WINDOWS} windows: {final}; content preserved "
        f"over all {pcfg.max_objects} objects after {final['total_moves']} "
        f"migrations")
    log(f"engine trace (windows {trace['windows'][0]}-"
        f"{trace['windows'][-1]}): "
        f"device busy {trace['device_busy_ms_per_window']:.4f} ms a window, "
        f"busy share {trace['device_busy_share']:.3f}, idle share "
        f"{trace['device_idle_share']:.3f}, {trace['kernels_per_window']:.0f} "
        f"kernels a window, {trace['copies_memsets_per_window']:.0f} copies "
        f"and memsets")
    for k, v in trace["kernels"].items():
        log(f"  {k}: {v['launches']} launches, "
            f"{v['device_ms_per_launch']:.5f} ms device a launch, bound "
            f"{v['bound_ms']:.5f} ms")
    for k, v in trace["top_ms_per_window"].items():
        log(f"  {v:9.4f} ms a window  {k}")
    log(f"engine SimHeap: {SIM_WINDOWS} windows, backend on the card "
        f"{sg:.2f} s, on the CPU {sc:.2f} s, identical; last window "
        f"{hg.window_log[-1]}")
    log(f"phase 10: kernel checks and load {t[1] - t[0]:.1f} s, (b) "
        f"{t[2] - t[1]:.1f} s, (c) {t[3] - t[2]:.1f} s, (d) "
        f"{t[4] - t[3]:.1f} s, content {t[5] - t[4]:.1f} s, (f) "
        f"{t[6] - t[5]:.1f} s")
    return dict(kernels=kernels, graph=graph, trace=trace,
                eager_ms_per_window=eager_ms, eager_ops_per_s=ops_s,
                moved=[(int(a), int(b)) for a, b in moved],
                page_utilization={str(k): v for k, v in pu.items()},
                loaded_histogram=hist0, final=final,
                simheap=dict(card_s=sg, cpu_s=sc,
                             last_window=hg.window_log[-1]),
                seconds=t[-1] - t[0])


# ---------------------------------------------------------------------------
# phase 11: the hybrid path (zamba2-2.7b) at full width and depth
# ---------------------------------------------------------------------------
HYBRID_CUT = 12    # (c): two groups of five mamba2 blocks and the shared block


def prefill_by_origin(model, params, cfg, dev, rows=12):
    """One more prefill of `measure_prefill`'s prompts under torch.profiler
    with the port's functions labelled (`_labelled`): its device time by
    the outermost port function that launched it ("?" outside any) and by
    port function and host op, the largest `rows` of those printed (a
    trace that is not whole, `trace_events`, is taken again)."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    batch = _prompts(cfg, dev, seed=0)
    for attempt in range(1, PROFILES + 1):
        with _labelled(), profile(activities=[ProfilerActivity.CPU,
                                              ProfilerActivity.CUDA]) as prof:
            open_trace()
            model.prefill(params, batch)
            close_trace()
        events, ok = trace_events(prof)
        if ok:
            break
        log(f"{cfg.name} prefill by origin: trace {attempt} of at most "
            f"{PROFILES} lost spin kernels of its own; profiling it again")
    cpu_t = torch.autograd.DeviceType.CPU
    by_op = _by_origin([e for e in events if e.device_type == cpu_t], 1)
    by_fn = collections.defaultdict(float)
    for key, r in by_op.items():
        by_fn[key.split(">")[0].split(" | ")[0]] += r["device_ms"]
    total = sum(by_fn.values())
    # the trace's own device work, annotations left out, for comparison
    device_ms = sum(e.time_range.elapsed_us() for e in events
                    if e.device_type != cpu_t
                    and not getattr(e, "is_user_annotation", False)
                    and e.name not in _LABELS) / 1e3
    if not total:
        raise AssertionError("the profiler recorded no device activity")
    log(f"{cfg.name} prefill by launching function: " + ", ".join(
        f"{k} {v:.1f} ms" for k, v in sorted(by_fn.items(),
                                             key=lambda kv: -kv[1]))
        + f" ({total:.1f} ms attributed, {device_ms:.1f} ms of device work "
        "in the trace)")
    top = sorted(by_op.items(), key=lambda kv: -kv[1]["device_ms"])[:rows]
    for name, r in top:
        log(f"  {r['device_ms']:9.3f} ms  {name[:110]}  ({r['kernels']:.0f} "
            f"kernels, {r['copies']:.0f} copies)")
    return dict(attributed_ms=total, device_ms=device_ms,
                by_function_ms=dict(by_fn),
                top_ms={k: r["device_ms"] for k, r in top})


def hybrid_path(dev):
    """(a) zamba2-2.7b at full width and depth (9 groups of 5 mamba2 blocks
    and the shared attention block, random bf16 weights from a seeded
    generator), attn_impl="flash": `Model.prefill` on B=2 x S=4096 with
    exactly 9 flash_attention launches (all `flash_attention_wgmma_kernel`
    in the profile, none of the CUDA-core kernel), 45 mamba_scan launches
    and no other kernel, finite logits, and phase 8's measurements, then
    the device time of one prefill by the port function that launched it
    (`prefill_by_origin`); (b)
    decode of 8 sequences, 45 mamba_scan launches and nothing else a step,
    and the bf16 drift (reported); (c) at full width and 12 layers (two
    groups), phase 6's comparisons: flash against blockwise in float32 and
    bfloat16, and the prefill with mamba_scan's plain version patched in,
    with the float32 decode against the prefill within 1e-3."""
    import torch
    from repro_torch.models.model import Model
    t = [time.perf_counter()]
    arch = "zamba2-2.7b"
    cfg = _cut(arch)
    model = Model(cfg, attn_impl="flash", device="cuda")
    params = model.init(torch.Generator(device=dev).manual_seed(0))
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in _leaves(params))
    n_attn, n_ssm = _n_blocks(cfg, "attn"), _n_blocks(cfg, "ssm")
    log(f"{cfg.name}: {cfg.num_layers} blocks ({n_ssm} mamba2, {n_attn} "
        f"occurrences of the shared block), d_model {cfg.d_model}, "
        f"{n_params / 1e9:.3f} B params ({cfg.dtype}), init "
        f"{time.perf_counter() - t[0]:.1f} s")
    with torch.inference_mode():
        res = dict(params=n_params, prefill=measure_prefill(
            model, params, cfg, dev,
            {"flash_attention": n_attn, "mamba_scan": n_ssm},
            {"flash_attention_wgmma_kernel": n_attn,
             "mamba_scan_kernel": n_ssm}, absent="flash_attention_kernel"))
        res["prefill_by_origin"] = prefill_by_origin(model, params, cfg, dev)
        t.append(time.perf_counter())
        res["decode"] = decode_run(model, params, cfg, dev)
        res["drift_bf16"] = mamba_drift(model, params, cfg, dev)
    del params
    torch.cuda.empty_cache()
    t.append(time.perf_counter())
    res["kernel_vs_plain"] = dict(
        flash=prefill_flash_vs_blockwise(dev, arch, layers=HYBRID_CUT),
        mamba_scan=mamba_kernel_vs_plain(dev, arch, layers=HYBRID_CUT,
                                         attn_impl="flash"))
    t.append(time.perf_counter())
    log(f"phase 11 (a) {t[1] - t[0]:.1f} s, (b) {t[2] - t[1]:.1f} s, (c) "
        f"{t[3] - t[2]:.1f} s")
    return res


# ---------------------------------------------------------------------------
# phase 12: training (zamba2-2.7b whole; kernel gradients, remat, resume)
# ---------------------------------------------------------------------------
TRAIN_B, TRAIN_S, TRAIN_STEPS = 2, 4096, 6   # (a)
REMAT_CUT, REMAT_S = 4, 2048                 # (c): chatglm3-6b's 4 of 28
RESUME_S = 256                               # (d): zamba2-2.7b reduced


@contextlib.contextmanager
def deterministic():
    """torch.use_deterministic_algorithms(True) inside (cuBLAS's
    workspace is pinned by CUBLAS_WORKSPACE_CONFIG, which `main` sets
    before CUDA starts)."""
    import torch
    torch.use_deterministic_algorithms(True)
    try:
        yield
    finally:
        torch.use_deterministic_algorithms(False)


def _trainer(model, b, s, steps, ckpt_dir, ckpt_every=None):
    """A `Trainer` of `model` on `TokenPipeline(seed=0)` batches of b x s,
    AdamW as `launch/train.py` builds it for `steps`, every step logged,
    and no checkpoint before the run's end unless `ckpt_every`."""
    from repro_torch.data.lm import DataConfig
    from repro_torch.launch.train import opt_config
    from repro_torch.runtime.trainer import Trainer, TrainerConfig
    return Trainer(model, DataConfig(vocab_size=model.cfg.vocab_size,
                                     seq_len=s, global_batch=b, seed=0),
                   opt_config(3e-4, steps),
                   TrainerConfig(ckpt_dir=ckpt_dir, log_every=1,
                                 ckpt_every=ckpt_every or steps + 1,
                                 keep_last=steps))


def _grads(model, params, batch):
    """The loss and its gradient for every param leaf (requires_grad on
    for the call only)."""
    import torch
    from repro_torch import tree as tree_lib
    leaves = tree_lib.leaves(params)
    for p in leaves:
        p.requires_grad_(True)
    try:
        loss = model.loss(params, batch)[0]
        grads = torch.autograd.grad(loss, leaves, allow_unused=True,
                                    materialize_grads=True)
    finally:
        for p in leaves:
            p.requires_grad_(False)
    return loss.detach(), grads


def _diff(ga, gb):
    """(leaves that differ in dtype or value, largest |difference|) of two
    lists of tensors."""
    import torch
    bad = [i for i, (x, y) in enumerate(zip(ga, gb))
           if x.dtype != y.dtype or not torch.equal(x, y)]
    err = max(((x.float() - y.float()).abs().max().item()
               for x, y in zip(ga, gb)), default=0.0)
    return bad, err


def _train_origin(e) -> str:
    """Where the device work of a host op of a train step comes from: the
    outermost labelled port function of the forward pass, "recompute:
    <function>" for the same under the backward pass (a checkpointed
    group run again), "backward: mamba_scan_bwd" for the backward kernel's
    wrapper, "backward" for autograd's own ops, "?" outside all of them
    (the loss's log-softmax and gather)."""
    port, bwd, op = [], False, e
    while op is not None:
        if op.name in _LABELS:
            port.insert(0, op.name)
        elif op.name.startswith("autograd::engine::evaluate_function"):
            bwd = True
        op = op.cpu_parent
    if "ops.mamba_scan_bwd" in port:
        return "backward: ops.mamba_scan_bwd"
    if bwd:
        return f"recompute: {port[0]}" if port else "backward"
    return port[0] if port else "?"


def profile_train_step(tr, params, opt, step, want):
    """One more `train_step` under torch.profiler with the port's functions
    labelled (`_labelled`): its wall, the device's busy and idle share,
    the launches of each port kernel (exactly `want`) and of its device
    kernel in the trace, and the device time by where it comes from
    (`_train_origin`). A trace that is not whole is taken again (each
    take is one more step)."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.kernels import ops
    cpu_t = torch.autograd.DeviceType.CPU
    batch = tr.data.batch_at(step)
    for attempt in range(1, PROFILES + 1):
        ops.reset_launches()
        with _labelled(), profile(activities=[ProfilerActivity.CPU,
                                              ProfilerActivity.CUDA]) as prof:
            open_trace()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            tr.train_step(params, opt, batch)
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3
            close_trace()
        launches = dict(ops.launches)
        events, ok = trace_events(prof)
        dev_ev = [e for e in events if e.device_type != cpu_t
                  and not getattr(e, "is_user_annotation", False)
                  and e.name not in _LABELS]
        seen = {k: sum(k in e.name for e in dev_ev)
                for k in ("mamba_scan_kernel", "mamba_scan_bwd_kernel")}
        if ok:
            break
        log(f"train step trace {attempt} of at most {PROFILES} lost spin "
            "kernels of its own; profiling another step")
    _only(launches, want)
    if seen != {"mamba_scan_kernel": want["mamba_scan"],
                "mamba_scan_bwd_kernel": want["mamba_scan_bwd"]}:
        raise AssertionError(f"the profiled step ran {seen}, want {want}")
    busy_us = _busy_us([(e.time_range.start, e.time_range.end)
                        for e in dev_ev])
    by_fn = collections.defaultdict(float)
    for e in events:
        if e.device_type != cpu_t or not (e.name.startswith("aten::")
                                          or e.name in _LABELS):
            continue
        for k in getattr(e, "kernels", None) or ():
            by_fn[_train_origin(e)] += k.duration / 1e3
    total = sum(by_fn.values())
    res = dict(wall_ms=wall_ms, device_busy_ms=busy_us / 1e3,
               device_idle_share=1 - busy_us / 1e3 / wall_ms,
               device_kernels=len(dev_ev), launches=launches,
               kernels_in_trace=seen, attributed_ms=total,
               by_origin_ms=dict(sorted(by_fn.items(),
                                        key=lambda kv: -kv[1])))
    log(f"profiled train step: wall {wall_ms:.1f} ms, device busy "
        f"{busy_us / 1e3:.1f} ms (idle share {res['device_idle_share']:.5f}"
        f"), {len(dev_ev)} device records, launches {launches}, in the "
        f"trace {seen}; device time by origin ({total:.1f} ms attributed): "
        + ", ".join(f"{k} {v:.1f}" for k, v in res["by_origin_ms"].items()))
    return res


def train_full(dev):
    """(a) zamba2-2.7b at full width and depth, bf16, remat="full",
    attn_impl="blockwise": TRAIN_STEPS steps of `Trainer.run` on B x S =
    TRAIN_B x TRAIN_S tokens (B=1 if B=2 runs out of memory: the cut is
    listed), every loss and grad norm finite, exactly 90 mamba_scan
    launches (45 forward, 45 recompute) and 45 mamba_scan_bwd a step and
    nothing else; ms a step (median of steps 2 on), train tok/s, peak
    memory, the final save's time; then one profiled step."""
    import shutil
    import tempfile
    import torch
    from repro_torch.kernels import ops
    from repro_torch.models.model import Model
    cfg = _cut("zamba2-2.7b")
    model = Model(cfg, attn_impl="blockwise", remat="full", device="cuda")
    n_ssm = _n_blocks(cfg, "ssm")
    want = {"mamba_scan": 2 * n_ssm, "mamba_scan_bwd": n_ssm}
    cut = None
    for b in (TRAIN_B, 1):
        params = model.init(torch.Generator(device=dev).manual_seed(0))
        ckpt_dir = tempfile.mkdtemp(prefix="chip_smoke_train_")
        tr = _trainer(model, b, TRAIN_S, TRAIN_STEPS, ckpt_dir)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        ops.reset_launches()
        t0 = time.perf_counter()
        try:
            out = tr.run(params, TRAIN_STEPS)
        except torch.cuda.OutOfMemoryError as e:
            if b == 1:
                raise
            cut = f"B={b} ran out of device memory ({str(e)[:120]}): B=1"
            log(f"train (a): {cut}")
            del params, tr
            torch.cuda.empty_cache()
            continue
        finally:
            shutil.rmtree(ckpt_dir, ignore_errors=True)
        run_s = time.perf_counter() - t0
        break
    launches = dict(ops.launches)
    peak = torch.cuda.max_memory_allocated()
    mem = torch.cuda.memory_stats()
    hist = [m for _, m in out["history"]]
    steps_ms = [m["step_time_s"] * 1e3 for m in hist]
    ms = float(np.median(steps_ms[1:]))
    res = dict(batch=b, seq_len=TRAIN_S, steps=TRAIN_STEPS, cut=cut,
               params=sum(p.numel() for p in _leaves(out["params"])),
               losses=[m["loss"] for m in hist],
               grad_norms=[m["grad_norm"] for m in hist],
               lrs=[m["lr"] for m in hist], step_ms=steps_ms,
               ms_per_step=ms, train_tok_per_s=b * TRAIN_S / ms * 1e3,
               run_s=run_s, final_save_s=run_s - sum(steps_ms) / 1e3,
               peak_device_bytes=peak, launches=launches,
               stragglers=out["stragglers"],
               alloc_retries=mem.get("num_alloc_retries", 0),
               launches_per_step={k: v / TRAIN_STEPS
                                  for k, v in launches.items() if v})
    log(f"train (a): {cfg.name} full width and depth, "
        f"{res['params'] / 1e9:.3f} B params bf16, B={b} x S={TRAIN_S}, "
        "remat full: losses "
        f"{[round(x, 4) for x in res['losses']]}, grad norms "
        f"{[round(x, 3) for x in res['grad_norms']]}, step ms "
        f"{[round(x, 1) for x in steps_ms]}: {ms:.1f} ms a step, "
        f"{res['train_tok_per_s']:.0f} train tok/s; peak device memory "
        f"{peak / 2**30:.2f} GiB; run {run_s:.1f} s of which the final save "
        f"{res['final_save_s']:.1f} s; stragglers (step, s, ewma s) "
        f"{res['stragglers']}, allocator retries {res['alloc_retries']}; "
        f"launches {launches}")
    _only(launches, {k: v * TRAIN_STEPS for k, v in want.items()})
    if not all(np.isfinite(res["losses"] + res["grad_norms"])):
        raise AssertionError("a loss or grad norm is not finite")
    res["profiled"] = profile_train_step(tr, out["params"], out["opt"],
                                         TRAIN_STEPS, want)
    del out, params, tr
    torch.cuda.empty_cache()
    return res


def train_kernel_vs_plain(dev):
    """(b) zamba2-2.7b at full width and 12 layers (two groups), float32
    (TF32 off), remat="full", B=2 x S=4096: every leaf's gradient through
    the scan kernels against the same step with `ops.mamba_scan` patched
    to `ref.mamba_scan` (autograd through its loop), under deterministic
    algorithms: bit for bit, since the backward kernel equals autograd
    through the loop bit for bit and every other op is the same
    deterministic call."""
    import torch
    from repro_torch.data.lm import DataConfig, TokenPipeline
    from repro_torch.kernels import ops, ref
    from repro_torch.models.model import Model
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = _cut("zamba2-2.7b", layers=HYBRID_CUT, dtype="float32")
    model = Model(cfg, remat="full", device="cuda")
    params = model.init(torch.Generator(device=dev).manual_seed(1))
    batch = TokenPipeline(DataConfig(cfg.vocab_size, TRAIN_S, TRAIN_B),
                          device=dev).batch_at(0)
    n_ssm = _n_blocks(cfg, "ssm")
    with deterministic():
        ops.reset_launches()
        loss_k, g_k = _grads(model, params, batch)
        launches = dict(ops.launches)
        with mock.patch.object(ops, "mamba_scan", ref.mamba_scan):
            loss_p, g_p = _grads(model, params, batch)
        torch.cuda.synchronize()
    bad, err = _diff(g_k, g_p)
    top = max(g.abs().max().item() for g in g_p)
    res = dict(layers=cfg.num_layers, leaves=len(g_k), leaves_differing=len(
        bad), max_abs_err=err, max_abs_grad=top, loss_kernel=loss_k.item(),
        loss_plain=loss_p.item(), launches=launches)
    log(f"train (b): {cfg.name} {cfg.num_layers} blocks fp32, B={TRAIN_B} "
        f"x S={TRAIN_S}: gradients of {len(g_k)} leaves through the kernels "
        f"vs the plain scan: {len(bad)} differ, max |err| {err:.3g} (max "
        f"|g| {top:.3g}); loss {res['loss_kernel']!r} vs "
        f"{res['loss_plain']!r}; launches {launches}")
    _only(launches, {"mamba_scan": 2 * n_ssm, "mamba_scan_bwd": n_ssm})
    if bad or loss_k.item() != loss_p.item():
        raise AssertionError(f"kernel gradients differ from the plain "
                             f"ones: {res}")
    del params, g_k, g_p
    torch.cuda.empty_cache()
    return res


def train_remat(dev):
    """(c) chatglm3-6b at full width, 4 of 28 layers, bf16, B=2 x
    S=2048: one step's gradients under remat "none", "full" and "dots"
    from the same params and batch under deterministic algorithms, bit for
    bit equal; then three `Trainer` steps (remat "dots") with finite
    losses."""
    import shutil
    import tempfile
    import torch
    from repro_torch.data.lm import DataConfig, TokenPipeline
    from repro_torch.models.model import Model
    cfg = _cut("chatglm3-6b", layers=REMAT_CUT)
    params = Model(cfg, device="cuda").init(
        torch.Generator(device=dev).manual_seed(2))
    batch = None
    grads, walls, peaks = {}, {}, {}
    with deterministic():
        for remat in ("none", "full", "dots"):
            model = Model(cfg, remat=remat, device="cuda")
            batch = batch or TokenPipeline(
                DataConfig(cfg.vocab_size, REMAT_S, TRAIN_B),
                device=dev).batch_at(0)
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            grads[remat] = _grads(model, params, batch)
            torch.cuda.synchronize()
            walls[remat] = (time.perf_counter() - t0) * 1e3
            peaks[remat] = torch.cuda.max_memory_allocated()
    diffs = {r: _diff(grads["none"][1], grads[r][1]) for r in ("full",
                                                                "dots")}
    same_loss = all(grads[r][0].item() == grads["none"][0].item()
                    for r in grads)
    log(f"train (c): {cfg.name} {cfg.num_layers} layers bf16, B={TRAIN_B} x "
        f"S={REMAT_S}: leaves differing from remat none: "
        + ", ".join(f"{r} {len(b)} (max |err| {e:.3g})"
                    for r, (b, e) in diffs.items())
        + f"; loss and gradient ms {walls}; peak GiB "
        f"{ {r: round(p / 2**30, 2) for r, p in peaks.items()} }")
    if not same_loss or any(b for b, _ in diffs.values()):
        raise AssertionError(f"remat policies disagree: {diffs}")
    del grads
    model = Model(cfg, remat="dots", device="cuda")
    ckpt_dir = tempfile.mkdtemp(prefix="chip_smoke_remat_")
    try:
        out = _trainer(model, TRAIN_B, REMAT_S, 3, ckpt_dir).run(params, 3)
    finally:
        shutil.rmtree(ckpt_dir, ignore_errors=True)
    losses = [m["loss"] for _, m in out["history"]]
    log(f"train (c): three Trainer steps (remat dots): losses "
        f"{[round(x, 4) for x in losses]}, step ms "
        f"{[round(m['step_time_s'] * 1e3, 1) for _, m in out['history']]}")
    if len(losses) != 3 or not np.isfinite(losses).all():
        raise AssertionError(f"Trainer losses {losses}")
    del out, params
    torch.cuda.empty_cache()
    return dict(layers=cfg.num_layers, seq_len=REMAT_S, grad_ms=walls,
                peak_device_bytes=peaks,
                leaves_differing={r: len(b) for r, (b, _) in diffs.items()},
                trainer_losses=losses)


def train_resume(dev):
    """(d) zamba2-2.7b reduced (bf16, remat "full", B=2 x S=256) under
    deterministic algorithms: 6 `Trainer` steps with ckpt_every=3; a fresh
    Trainer given only step 3's checkpoint resumes there and replays
    steps 4-6: the same losses and the same final params and optimizer
    state, bit for bit."""
    import os
    import shutil
    import tempfile
    import torch
    from repro_torch import tree as tree_lib
    from repro_torch.configs import get_config
    from repro_torch.models.model import Model
    model = Model(get_config("zamba2-2.7b", reduced=True), remat="full",
                  device="cuda")
    root = tempfile.mkdtemp(prefix="chip_smoke_resume_")
    a, b = os.path.join(root, "a"), os.path.join(root, "b")
    try:
        with deterministic():
            whole = _trainer(model, TRAIN_B, RESUME_S, 6, a, 3).run(
                model.init(torch.Generator(device=dev).manual_seed(0)), 6)
            os.makedirs(b)
            shutil.copytree(os.path.join(a, "step_3"),
                            os.path.join(b, "step_3"))
            resumed = _trainer(model, TRAIN_B, RESUME_S, 6, b, 3).run(
                model.init(torch.Generator(device=dev).manual_seed(9)), 6)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    want = [m["loss"] for _, m in whole["history"][3:]]
    got = [m["loss"] for _, m in resumed["history"]]
    bad_p, err = _diff(tree_lib.leaves(whole["params"]),
                       tree_lib.leaves(resumed["params"]))
    bad_o, _ = _diff(tree_lib.leaves(whole["opt"]),
                     tree_lib.leaves(resumed["opt"]))
    log(f"train (d): resumed from step 3: steps "
        f"{[s for s, _ in resumed['history']]} losses {got} (whole run "
        f"{want}); params differing {len(bad_p)} (max |err| {err:.3g}), "
        f"optimizer leaves differing {len(bad_o)}")
    if got != want or bad_p or bad_o or             [s for s, _ in resumed["history"]] != [4, 5, 6]:
        raise AssertionError("the resumed run does not replay the whole one")
    return dict(losses=got, params_differing=len(bad_p),
                opt_differing=len(bad_o))


def train_path(dev):
    """Phase 12: (a) `train_full`, (b) `train_kernel_vs_plain`, (c)
    `train_remat`, (d) `train_resume`."""
    t = [time.perf_counter()]
    res = {}
    for key, fn in (("full", train_full), ("kernel_vs_plain",
                                           train_kernel_vs_plain),
                    ("remat", train_remat), ("resume", train_resume)):
        res[key] = fn(dev)
        t.append(time.perf_counter())
    log("phase 12 " + ", ".join(f"({k}) {t[i + 1] - t[i]:.1f} s"
                                for i, k in enumerate("abcd")))
    return res


# ---------------------------------------------------------------------------
# phase 13: the paper's evaluation substrate (CrestKV over SimHeap, the ten
# Table-1 structures) and the tiered embedding
# ---------------------------------------------------------------------------
TABLE1_KEYS = 60_000          # benchmarks/table1_structures.py
FIG7_KEYS = 40_000            # benchmarks/fig7_backends.py, --smoke
# (c): the paper's 10 M keys (benchmarks/common.py FULL_N_KEYS); three
# windows of 10 M ops (a window closes at the first 4096-op batch past it)
FULL_KEYS, FULL_WINDOW_OPS, FULL_OPS = 10_000_000, 10_000_000, 40_000_000
# (a) and (b)'s 47 short runs share a pool of worker processes; (c) runs
# alone, so that its host seconds are its own
CREST_WORKERS = 6
EMB_ARCH, EMB_WINDOWS, EMB_WRITES = "zamba2-2.7b", 16, 64   # (d)
EMB_B, EMB_S = 2, 4096
CREST_ARRAYS = ("addr", "size", "heap", "access", "ciw", "atc", "resident",
                "referenced", "evict")


def steady(windows, key, tail=4):
    """benchmarks/common.py's steady state: the mean over the last `tail`
    windows."""
    xs = [w[key] for w in windows[-tail:]]
    return float(np.mean(xs)) if xs else float("nan")


def _crest_digest(kv, stats) -> dict:
    """A CrestKV run reduced to what the card and CPU comparison holds:
    the run statistics, window logs and heap counters as they are, and the
    value ids and the SimHeap's placement and page arrays as (dtype,
    SHA-256) pairs."""
    import hashlib
    h = kv.heap
    out = {k: getattr(stats, k) for k in ("windows", "ops", "total_ns",
                                           "base_ns", "faults")}
    out.update({k: getattr(h, k) for k in (
        "window_log", "cursor", "live_bytes", "total_moves",
        "ciw_threshold", "epoch")})
    arrays = dict({k: getattr(h, k) for k in CREST_ARRAYS},
                  value_obj=kv.value_obj)
    out.update({k: (str(v.dtype), hashlib.sha256(
        np.ascontiguousarray(v)).hexdigest()) for k, v in arrays.items()})
    return out


TABLE1_SYSTEMS = (("base", dict(backend="null", enabled=False)),
                  ("hades", dict(backend="proactive", enabled=True)))


def fig7_systems(target):
    """fig7_backends.py's six systems under a target of `target` bytes."""
    return {
        "cgroup_cap": dict(backend="cap", enabled=False,
                           hbm_target_bytes=target),
        "kswapd_pressure": dict(backend="reactive", enabled=False,
                                hbm_target_bytes=target),
        "hades_reactive": dict(backend="reactive", enabled=True,
                               hbm_target_bytes=target),
        "hades_proactive": dict(backend="proactive", enabled=True),
        "hades_mglru": dict(backend="mglru", enabled=True,
                            hbm_target_bytes=target),
        "hades_promote": dict(backend="promote", enabled=True,
                              hbm_target_bytes=target),
    }


def _crest_job(structure, workload, n_keys, n_ops, dev, sim):
    """One run of benchmarks/common.py's `run_crest` on the port (store
    seed 0, key stream seed 1, a window of 3 x keys), in a worker process:
    (stats, digest, host s)."""
    from repro_torch.data.crestkv import CrestKV, default_sim_config
    t0 = time.perf_counter()
    kv = CrestKV(structure, n_keys, default_sim_config(n_keys, **sim),
                 seed=0, device=dev)
    stats = kv.run(workload, n_ops, window_ops=3 * n_keys, seed=1)
    return stats, _crest_digest(kv, stats), time.perf_counter() - t0


def crest_table1_fig7(dev):
    """(a) Table 1: each structure under YCSB-A (12 ops a key) as the
    baseline (`null`, no tidying) and as HADES (`proactive`), each with the
    SimHeap's backend on the card and on the CPU: identical runs; the
    numbers are table1_structures.py's, from the card's runs. (b) fig 7
    at its smoke size: hash-pugh under YCSB-C (60 ops a key), the free run
    and fig7_backends.py's six systems, the backend on the card, the
    target at 40 % of the free run's footprint. Every run counts its ops
    and keeps page utilization in (0, 1]. The 47 runs share a pool of
    CREST_WORKERS processes."""
    import multiprocessing
    from repro_torch.data.structures import STRUCTURES
    names, n, m = sorted(STRUCTURES), TABLE1_KEYS, FIG7_KEYS
    card = str(dev)
    with multiprocessing.get_context("spawn").Pool(CREST_WORKERS) as pool:
        def run(*args):
            return pool.apply_async(_crest_job, args)
        free = run("hash-pugh", "C", m, 60 * m, card,
                   dict(backend="null", enabled=False))
        table1 = {(name, label, side): run(name, "A", n, 12 * n, d, sim)
                  for name in names for label, sim in TABLE1_SYSTEMS
                  for side, d in (("card", card), ("cpu", "cpu"))}
        free = free.get()[0]
        footprint = steady(free.windows, "rss_bytes")
        target = int(footprint * 0.4)
        fig7 = {name: run("hash-pugh", "C", m, 60 * m, card, sim)
                for name, sim in fig7_systems(target).items()}
        table1 = {k: v.get() for k, v in table1.items()}
        fig7 = {k: v.get() for k, v in fig7.items()}
    runs = [(k, v[0], 12 * n) for k, v in table1.items()] + \
        [(k, v[0], 60 * m) for k, v in fig7.items()] + \
        [("free_run", free, 60 * m)]
    for what, stats, ops in runs:
        if stats.ops != ops or not all(0 < w["page_utilization"] <= 1
                                       for w in stats.windows):
            raise AssertionError(f"phase 13 {what}: ops {stats.ops} of "
                                 f"{ops} or page utilization out of (0, 1]")
    rows = []
    for name in names:
        for label, _ in TABLE1_SYSTEMS:
            got = table1[name, label, "card"][1]
            want = table1[name, label, "cpu"][1]
            bad = [k for k in want if got[k] != want[k]]
            if bad:
                raise AssertionError(f"phase 13 (a) {name} {label}: the "
                                     f"card's run differs from the CPU's in "
                                     f"{bad}")
        base = table1[name, "base", "card"][0]
        hades = table1[name, "hades", "card"][0]
        r = dict(structure=name,
                 pu_gain=steady(hades.windows, "page_utilization") /
                 max(steady(base.windows, "page_utilization"), 1e-9),
                 mem_reduction=1 - steady(hades.windows, "rss_bytes") /
                 max(steady(base.windows, "rss_bytes"), 1.0),
                 overhead=hades.overhead_frac, windows=len(hades.windows),
                 card_equals_cpu=True,
                 host_s={f"{label}_{side}": table1[name, label, side][2]
                         for label, _ in TABLE1_SYSTEMS
                         for side in ("card", "cpu")})
        log("phase 13 (a) " + json.dumps(r))
        rows.append(r)
    systems = []
    for name, (st, _, host_s) in fig7.items():
        r = dict(system=name,
                 rss_frac=steady(st.windows, "rss_bytes") / footprint,
                 slowdown=st.mean_latency_ns / free.mean_latency_ns - 1,
                 faults=st.faults, windows=len(st.windows), host_s=host_s)
        log("phase 13 (b) " + json.dumps(r))
        systems.append(r)
    return rows, dict(footprint_bytes=footprint,
                      target_frac=target / footprint,
                      free_run_windows=len(free.windows), systems=systems)


def _rss_bytes() -> int:
    """This process's resident set now (/proc/self/statm)."""
    with open("/proc/self/statm") as f:
        return int(f.read().split()[1]) * os.sysconf("SC_PAGE_SIZE")


def _no_overlap(h, dev) -> bool:
    """Every live object inside its heap's range, and no two overlapping
    (sorted on the card)."""
    import torch
    from repro_torch.core.simheap import ALIGN
    live = np.nonzero(h.heap >= 0)[0]
    addr = torch.from_numpy(h.addr[live]).to(dev)
    size = torch.from_numpy((h.size[live] + ALIGN - 1) // ALIGN * ALIGN) \
        .to(dev)
    base = torch.tensor([h.base[k] for k in sorted(h.base)],
                        device=dev)[torch.from_numpy(
                            h.heap[live].astype(np.int64)).to(dev)]
    inside = bool(((addr >= base) &
                   (addr + size <= base + h.cfg.heap_bytes)).all())
    addr, order = torch.sort(addr)
    size = size[order]
    return inside and bool((addr[1:] >= addr[:-1] + size[:-1]).all())


def crest_full(dev):
    """(c) the paper's scale: hash-pugh under YCSB-C with `proactive` at
    FULL_KEYS keys, three windows of 10 M ops, the backend on the card;
    alone, so its host seconds are its own. Gates: every op counted,
    addresses inside their heaps and disjoint, and in every window page
    utilization in (0, 1] and RSS at most the footprint (the pages under
    the three heaps' cursors, where every resident page lies).
    backend_step's span on the card from CUDA events around it (its
    uploads from pageable memory wait for the host, so host time between
    its copies counts too) beside its host seconds."""
    import resource
    import torch
    from repro_torch.core.simheap import PAGE
    rss0 = _rss_bytes()
    peak0 = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss * 1024
    t0 = time.perf_counter()
    from repro_torch.data.crestkv import CrestKV, default_sim_config
    kv = CrestKV("hash-pugh", FULL_KEYS, default_sim_config(
        FULL_KEYS, backend="proactive", enabled=True), seed=0, device=dev)
    h = kv.heap
    load_s = time.perf_counter() - t0
    load = dict(rss_bytes=h.rss_bytes(), process_rss_bytes=_rss_bytes())
    step, collect_s, step_s, win = h.backend_step, [], [], []
    events = []

    def timed_step():
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
        s0 = time.perf_counter()
        ev[0].record()
        step()
        ev[1].record()
        step_s.append(time.perf_counter() - s0)
        events.append(ev)

    collect = h.collect

    def timed_collect():
        c0 = time.perf_counter()
        report = collect()
        collect_s.append(time.perf_counter() - c0)
        return report

    marks = [time.perf_counter()]

    def on_window(report):
        marks.append(time.perf_counter())
        footprint = PAGE * sum(
            (h.base[k] + h.cursor[k]) // PAGE + 1 - h.base[k] // PAGE
            for k in h.base)
        win.append(dict(page_utilization=report["page_utilization"],
                        rss_bytes=report["rss_bytes"],
                        footprint_bytes=footprint,
                        moved_to_hot=report.get("moved_to_hot"),
                        moved_to_cold=report.get("moved_to_cold"),
                        process_rss_bytes=_rss_bytes()))

    with mock.patch.object(h, "backend_step", timed_step), \
            mock.patch.object(h, "collect", timed_collect):
        stats = kv.run("C", FULL_OPS, window_ops=FULL_WINDOW_OPS, seed=1,
                       on_window=on_window)
    run_s = time.perf_counter() - marks[0]
    torch.cuda.synchronize()
    for w, (a, b), c, bs, m0, m1 in zip(win, events, collect_s, step_s,
                                        marks, marks[1:]):
        w.update(host_s=m1 - m0, collect_s=c, backend_step_s=bs,
                 backend_step_device_ms=a.elapsed_time(b))
    t1 = time.perf_counter()
    disjoint = _no_overlap(h, dev)
    check_s = time.perf_counter() - t1
    bad = [i for i, w in enumerate(win) if not (
        0 < w["page_utilization"] <= 1 and
        w["rss_bytes"] <= w["footprint_bytes"])]
    if stats.ops != FULL_OPS or len(win) < 3 or bad or not disjoint:
        raise AssertionError(
            f"phase 13 (c): ops {stats.ops} of {FULL_OPS}, {len(win)} "
            f"windows, windows out of bounds {bad}, addresses disjoint "
            f"{disjoint}")
    peak = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss * 1024
    res = dict(keys=FULL_KEYS, ops=stats.ops,
               window_ops=FULL_WINDOW_OPS, objects=h.cfg.max_objects,
               live_objects=int((h.heap >= 0).sum()),
               pages_to_backend=h.n_pages, load_s=load_s, run_s=run_s,
               check_s=check_s, load=load, windows=win,
               overhead=stats.overhead_frac,
               process_rss_before_bytes=rss0,
               process_peak_rss_bytes=peak,
               peak_is_this_phase=peak > peak0)
    del kv, h
    for w in win:
        log("phase 13 (c) window " + json.dumps(w))
    log("phase 13 (c) " + json.dumps({k: v for k, v in res.items()
                                      if k != "windows"}))
    return res


def _emb_state_diff(a, b) -> list:
    """The leaves of two embedding states (or reports) that differ."""
    return _states_equal({k: v.cpu() for k, v in a.items()},
                         {k: v.cpu() for k, v in b.items()})


def embedding_run(dev):
    """(d) the tiered embedding at zamba2-2.7b's width: vocab 32000 x 2560
    bf16 (a seeded generator's table), its `embed_hot_rows` = 4096 hot
    rows; EMB_WINDOWS windows, each one `lookup` of B=2 x S=4096 tokens of
    `TokenPipeline(seed=0)` then `collect`, then `write_rows` of 64
    distinct rows, half of them hot; on the card and on the CPU, every
    output and state leaf identical. Then ms per lookup and per collect
    (CUDA events)."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.data.lm import DataConfig, TokenPipeline
    from repro_torch.models import embedding as emb
    mc = get_config(EMB_ARCH)
    cfg = emb.TieredEmbeddingConfig(vocab_size=mc.vocab_size,
                                    d_model=mc.d_model,
                                    hot_rows=mc.hades.embed_hot_rows)
    table = torch.randn(cfg.vocab_size, cfg.d_model, generator=torch.
                        Generator().manual_seed(0)).to(torch.bfloat16)
    data = DataConfig(vocab_size=cfg.vocab_size, seq_len=EMB_S,
                      global_batch=EMB_B, seed=0)
    pipes = {d: TokenPipeline(data, device=d) for d in (dev, "cpu")}
    states = {d: emb.init(cfg, table.to(d)) for d in (dev, "cpu")}
    windows, bad = [], []
    for w in range(EMB_WINDOWS):
        outs, looked, reps = {}, {}, {}
        for d in (dev, "cpu"):
            toks = pipes[d].batch_at(w)["tokens"]
            outs[d], looked[d] = emb.lookup(cfg, states[d], toks)
            states[d], reps[d] = emb.collect(cfg, looked[d])
        if not torch.equal(outs[dev].cpu(), outs["cpu"]):
            bad.append(f"window {w} embeddings")
        bad += [f"window {w} after lookup {k}" for k in
                _emb_state_diff(looked[dev], looked["cpu"])]
        bad += [f"window {w} {k}" for k in
                _emb_state_diff(states[dev], states["cpu"])]
        bad += [f"window {w} report {k}" for k in
                _emb_state_diff(reps[dev], reps["cpu"])]
        windows.append({k: float(v) for k, v in reps[dev].items()})
    rng = np.random.default_rng(0)
    hot = states["cpu"]["hot_ids"].numpy()
    cold = np.setdiff1d(np.arange(cfg.vocab_size), hot)
    rows = rng.permutation(np.concatenate([
        rng.choice(hot, EMB_WRITES // 2, replace=False),
        rng.choice(cold, EMB_WRITES // 2, replace=False)]))
    vals = torch.randn(EMB_WRITES, cfg.d_model, generator=torch.Generator()
                       .manual_seed(1)).to(torch.bfloat16)
    written = {d: emb.write_rows(states[d], torch.from_numpy(rows).to(d),
                                 vals.to(d)) for d in (dev, "cpu")}
    bad += [f"write_rows {k}" for k in
            _emb_state_diff(written[dev], written["cpu"])]
    if bad:
        raise AssertionError(f"phase 13 (d): the card differs from the CPU "
                             f"in {bad}")
    s, toks = states[dev], pipes[dev].batch_at(0)["tokens"]
    rows_d, vals_d = torch.from_numpy(rows).to(dev), vals.to(dev)
    lookup_ms = cuda_time(lambda: emb.lookup(cfg, s, toks), 20)
    collect_ms = cuda_time(lambda: emb.collect(cfg, s), 20)
    write_ms = cuda_time(lambda: emb.write_rows(s, rows_d, vals_d), 20)
    res = dict(vocab=cfg.vocab_size, d_model=cfg.d_model,
               hot_rows=cfg.hot_rows, windows=windows,
               card_equals_cpu=True, lookup_ms=lookup_ms,
               collect_ms=collect_ms, write_rows_ms=write_ms,
               hbm_frac=emb.hbm_bytes(cfg) / emb.total_bytes(cfg),
               hot_fractions=embedding_hot_fractions(dev))
    for i, w in enumerate(windows):
        log(f"phase 13 (d) window {i} " + json.dumps(w))
    log("phase 13 (d) " + json.dumps({k: v for k, v in res.items()
                                      if k != "windows"}))
    return res


def embedding_hot_fractions(dev):
    """benchmarks/bench_embedding.py on the card: vocab 32768 x 128 fp32
    (numpy seed 0), zipf 1.1 scattered ids, batches of 8192; at hot
    fractions 0.01, 0.05 and 0.25, four windows of lookup and collect, then
    the cold-hit rate of one more lookup (the steady rate). Six more
    lookups follow each, as the benchmark's timing draws them, so the
    random stream stays the benchmark's."""
    import torch
    from repro_torch.models import embedding as emb
    vocab, d = 32768, 128
    rng = np.random.default_rng(0)
    table = torch.from_numpy(rng.normal(size=(vocab, d)).astype(np.float32))\
        .to(dev)
    w = 1.0 / np.power(np.arange(1, vocab + 1, dtype=np.float64), 1.1)
    cdf = np.cumsum(w) / np.sum(w)
    scramble = rng.permutation(vocab)

    def batch(k=8192):
        return torch.from_numpy(scramble[np.searchsorted(
            cdf, rng.random(k))].astype(np.int32)).to(dev)
    out = {}
    for hot_frac in (0.01, 0.05, 0.25):
        cfg = emb.TieredEmbeddingConfig(vocab_size=vocab, d_model=d,
                                        hot_rows=max(int(vocab * hot_frac),
                                                     1))
        s = emb.init(cfg, table)
        for _ in range(4):
            _, s = emb.lookup(cfg, s, batch())
            s, rep = emb.collect(cfg, s)
        _, s = emb.lookup(cfg, s, batch())
        cold = int(s["win_cold_hits"]) / max(int(s["win_lookups"]), 1)
        for _ in range(6):
            emb.lookup(cfg, s, batch())
        out[str(hot_frac)] = dict(
            cold_hit_rate=cold, coverage=float(rep["hot_coverage"]),
            hbm_frac=emb.hbm_bytes(cfg, torch.float32) /
            emb.total_bytes(cfg, torch.float32))
    return out


def crest_path(dev):
    """Phase 13: (a) and (b) `crest_table1_fig7`, (c) `crest_full`, (d)
    `embedding_run`."""
    t = [time.perf_counter()]
    res = {}
    res["table1"], res["fig7"] = crest_table1_fig7(dev)
    t.append(time.perf_counter())
    res["full"] = crest_full(dev)
    t.append(time.perf_counter())
    res["embedding"] = embedding_run(dev)
    t.append(time.perf_counter())
    res["seconds"] = {k: t[i + 1] - t[i] for i, k in
                      enumerate(("a and b", "c", "d"))}
    log("phase 13 " + ", ".join(f"({k}) {v:.1f} s" for k, v in
                                res["seconds"].items()) +
        f", in all {t[-1] - t[0]:.1f} s")
    return res

# ---------------------------------------------------------------------------
# phase 14: the encoder-decoder (seamless-m4t-large-v2) and VLM
# (qwen2-vl-72b) families
# ---------------------------------------------------------------------------
ENC_ARCH, VLM_ARCH = "seamless-m4t-large-v2", "qwen2-vl-72b"
# qwen2-vl-72b's 80 layers are 135 GiB of bf16 weights, past the card's 80
# GB: (b) runs its first 16 (30.8 GiB with the embedding and the head)
VLM_CUT = 16
FAMILY_CUT = 2     # (c): layers (and encoder layers) at full width
FAMILY_DECODE = 8  # (a), (b): teacher-forced, then as many greedy steps


def _flash_modes(fn):
    """fn()'s result and its flash_attention calls by mask: {"causal": n,
    "non_causal": n} (a spy around the wrapper: the launches themselves
    are counted by `ops.launches`)."""
    from repro_torch.kernels import ops
    real, modes = ops.flash_attention, collections.Counter()

    def spy(q, k, v, *, causal=True, window=0):
        modes["causal" if causal else "non_causal"] += 1
        return real(q, k, v, causal=causal, window=window)
    with mock.patch.object(ops, "flash_attention", spy):
        out = fn()
    return out, dict(modes)


def _grid_positions(cfg, dev, b=PREFILL_B, s=PREFILL_S):
    """M-RoPE positions [3, b, s] of a VLM prompt: the P = g x g patches at
    t = 0, h = i // g, w = i % g, then the text tokens at g + j in all
    three streams."""
    import torch
    from repro_torch.models.model import vlm_patches
    p = vlm_patches(s)
    g = int(round(p ** 0.5))
    if g * g != p:
        raise ValueError(f"{p} patches make no square grid")
    i = torch.arange(p, device=dev)
    pos = torch.empty((3, b, s), dtype=torch.int64, device=dev)
    pos[0, :, :p] = 0
    pos[1, :, :p] = i // g
    pos[2, :, :p] = i % g
    pos[:, :, p:] = g + torch.arange(s - p, device=dev)
    return pos


def encdec_full(dev):
    """(a) seamless-m4t-large-v2 at full width and depth (24 + 24 layers,
    random bf16 weights from a seeded generator), attn_impl="flash": phase
    7's prefill of B=2 x S=4096 tokens over 1024 frame embeddings (exactly
    48 flash_attention launches, all on the tensor cores, 48
    `flash_attention_wgmma_kernel` in the profile: 24 non-causal in the
    encoder, 24 causal in the decoder, counted by mask in one more prefill)
    and its device time by launching function (`prefill_by_origin`), then
    decode of 8 sequences over the encoder's output of their own frames (no
    port kernel a step)."""
    import torch
    from repro_torch.models import transformer as T
    from repro_torch.models.model import Model
    cfg = _cut(ENC_ARCH)
    model = Model(cfg, attn_impl="flash", device="cuda")
    t0 = time.perf_counter()
    params = model.init(torch.Generator(device=dev).manual_seed(0))
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in _leaves(params))
    n_attn = _n_blocks(cfg, "attn")
    log(f"{cfg.name}: {cfg.num_encoder_layers} encoder + {cfg.num_layers} "
        f"decoder layers, d_model {cfg.d_model}, {n_params / 1e9:.3f} B "
        f"params ({cfg.dtype}), init {time.perf_counter() - t0:.1f} s")
    with torch.inference_mode():
        res = dict(params=n_params, prefill=measure_prefill(
            model, params, cfg, dev, {"flash_attention": n_attn},
            {"flash_attention_wgmma_kernel": n_attn},
            absent="flash_attention_kernel"))
        res["prefill_by_origin"] = prefill_by_origin(model, params, cfg, dev)
        _, modes = _flash_modes(lambda: model.prefill(
            params, _prompts(cfg, dev, seed=0)))
        want = {"causal": cfg.num_layers,
                "non_causal": cfg.num_encoder_layers}
        log(f"{cfg.name} prefill flash_attention calls by mask: {modes}")
        if modes != want:
            raise AssertionError(f"flash_attention calls {modes}, want "
                                 f"{want}")
        res["flash_modes"] = modes
        frames = _prompts(cfg, dev, seed=3, b=DECODE_B)["enc_embeds"]
        enc_out = T.encoder_forward(params, cfg, frames, attn_impl="flash")
        res["decode"] = decode_run(model, params, cfg, dev, FAMILY_DECODE,
                                   FAMILY_DECODE, enc_out=enc_out)
    del params, enc_out
    torch.cuda.empty_cache()
    return res


def vlm_full(dev):
    """(b) qwen2-vl-72b at full width and VLM_CUT layers (random bf16
    weights from a seeded generator), attn_impl="flash": phase 7's prefill
    of 256 patch embeddings and 3840 tokens (S = 4096; exactly 16
    flash_attention launches, all on the tensor cores) and its device time
    by launching function; the same prefill through `lm_forward` with the
    [3, B, S] grid positions (16 launches, finite logits, ms); then
    text-only decode of 8 sequences."""
    import torch
    from repro_torch.kernels import ops
    from repro_torch.models import transformer as T
    from repro_torch.models.model import Model
    cfg = _cut(VLM_ARCH, layers=VLM_CUT)
    model = Model(cfg, attn_impl="flash", device="cuda")
    t0 = time.perf_counter()
    params = model.init(torch.Generator(device=dev).manual_seed(0))
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in _leaves(params))
    log(f"{cfg.name}: {cfg.num_layers} of {_cut(VLM_ARCH).num_layers} "
        f"layers, d_model {cfg.d_model}, {n_params / 1e9:.3f} B params "
        f"({n_params * 2 / 2 ** 30:.1f} GiB {cfg.dtype}), init "
        f"{time.perf_counter() - t0:.1f} s")
    with torch.inference_mode():
        res = dict(params=n_params, layers=cfg.num_layers,
                   prefill=measure_prefill(
                       model, params, cfg, dev,
                       {"flash_attention": cfg.num_layers},
                       {"flash_attention_wgmma_kernel": cfg.num_layers},
                       absent="flash_attention_kernel"))
        res["prefill_by_origin"] = prefill_by_origin(model, params, cfg, dev)
        batch = _prompts(cfg, dev, seed=0)
        pos = _grid_positions(cfg, dev)
        walls = []
        for _ in range(2):
            torch.cuda.synchronize()
            ops.reset_launches()
            t0 = time.perf_counter()
            logits, _ = T.lm_forward(params, cfg, batch["tokens"],
                                     extra_embeds=batch["extra_embeds"],
                                     positions=pos, attn_impl="flash")
            torch.cuda.synchronize()
            walls.append((time.perf_counter() - t0) * 1e3)
            launches = dict(ops.launches)
            finite = bool(torch.isfinite(logits).all())
            del logits
        _only(launches, {"flash_attention": cfg.num_layers})
        if not finite:
            raise AssertionError("grid-position logits are not finite")
        res["grid_positions"] = dict(ms_per_prefill=walls[-1],
                                     runs_ms=walls, launches=launches)
        log(f"{cfg.name} prefill with [3, B, S] grid positions: "
            f"{walls[-1]:.1f} ms (runs {[round(w, 1) for w in walls]}), "
            f"launches {launches}, finite logits")
        res["decode"] = decode_run(model, params, cfg, dev, FAMILY_DECODE,
                                   FAMILY_DECODE)
    del params
    torch.cuda.empty_cache()
    return res


def family_kernel_vs_plain(dev, arch, layers=FAMILY_CUT):
    """(c) `arch` at full width and `layers` layers (and encoder layers),
    attn_impl="flash", in float32 (TF32 off) and bfloat16: the prefill
    with the kernel against the same call with flash_attention's plain
    version patched in, within phase 6's rule (5e-2 in float32, two bf16
    ulps of the largest logit in bfloat16); for the VLM also the prefill
    with [3, B, S] grid positions, kernel against plain under the same
    rule (blockwise masks by the temporal stream there, by design, so it
    is no reference for this run); in float32 the teacher-forced decode of
    B=2 x 64 tokens against their prefill (an encoder-decoder's over the
    prefill's own encoder output; a VLM's text only) within 1e-3 of the
    largest |logit|."""
    import torch
    from repro_torch.kernels import ops, ref
    from repro_torch.models import transformer as T
    from repro_torch.models.model import Model
    torch.backends.cuda.matmul.allow_tf32 = False
    out = dict(layers=layers, batch=PREFILL_B, seq_len=PREFILL_S)
    for dtype in ("float32", "bfloat16"):
        cfg = _cut(arch, layers=layers, dtype=dtype)
        model = Model(cfg, attn_impl="flash", device="cuda")
        params = model.init(torch.Generator(device=dev).manual_seed(2))
        batch = _prompts(cfg, dev, seed=1)
        runs = {"prefill": lambda: model.prefill(params, batch)}
        if cfg.frontend == "vision":
            pos = _grid_positions(cfg, dev)
            runs["grid_positions"] = lambda: T.lm_forward(
                params, cfg, batch["tokens"],
                extra_embeds=batch["extra_embeds"], positions=pos,
                attn_impl="flash")[0]
        res = {}
        with torch.inference_mode():
            for name, fn in runs.items():
                n0 = ops.launches["flash_attention"]
                kernel = fn()
                n = ops.launches["flash_attention"] - n0
                with mock.patch.object(ops, "flash_attention",
                                       ref.flash_attention):
                    plain = fn()
                err = (kernel - plain).abs().max().item()
                top = plain.abs().max().item()
                del kernel, plain
                tol = 5e-2 if dtype == "float32" else 2 ** -6 * top
                res[name] = dict(kernel_vs_plain=err, limit=tol,
                                 max_abs_logit=top, launches=n)
                log(f"{arch} {name} flash kernel vs plain ({dtype}, "
                    f"{layers} layers, full width, B={PREFILL_B} "
                    f"S={PREFILL_S}): logits max |err| {err:.3g} (< "
                    f"{tol:.3g}), max |logit| {top:.3g}; {n} "
                    "flash_attention launches")
                if n != _n_blocks(cfg, "attn"):
                    raise AssertionError(f"{n} flash_attention launches in "
                                         f"a {layers}-layer prefill")
                if not err < tol:
                    raise AssertionError(f"{arch} {name} {dtype}: kernel "
                                         f"vs plain {err}")
            if dtype == "float32":
                toks = batch["tokens"][:, :DRIFT_S]
                short = {"tokens": toks}
                if cfg.is_encoder_decoder:
                    short["enc_embeds"] = batch["enc_embeds"]
                pre, aux = T.lm_forward(params, cfg, toks,
                                        enc_embeds=short.get("enc_embeds"),
                                        attn_impl="flash", return_cache=True)
                dec = _decode_logits(model, params, toks,
                                     enc_out=aux["enc_out"])
                err = (dec - pre).abs().max().item()
                top = pre.abs().max().item()
                res["decode_vs_prefill"] = dict(err=err, max_abs_logit=top)
                log(f"{arch} decode vs prefill of B={PREFILL_B} x {DRIFT_S} "
                    f"tokens (float32): {err:.3g} (< 1e-3 x {top:.3g})")
                if not err < 1e-3 * top:
                    raise AssertionError(f"{arch} decode vs prefill {err}")
        del params
        out[dtype] = res
        torch.cuda.empty_cache()
    return out


def families_path(dev):
    """Phase 14: (a) `encdec_full`, (b) `vlm_full`, (c) for both at
    FAMILY_CUT layers, phase 6's rule: `prefill_flash_vs_blockwise` and
    `family_kernel_vs_plain`."""
    t = [time.perf_counter()]
    encdec = encdec_full(dev)
    t.append(time.perf_counter())
    vlm = vlm_full(dev)
    t.append(time.perf_counter())
    for arch, res in ((ENC_ARCH, encdec), (VLM_ARCH, vlm)):
        res["kernel_vs_plain"] = dict(
            blockwise=prefill_flash_vs_blockwise(dev, arch, FAMILY_CUT),
            plain=family_kernel_vs_plain(dev, arch))
    t.append(time.perf_counter())
    log(f"phase 14 (a) {t[1] - t[0]:.1f} s, (b) {t[2] - t[1]:.1f} s, (c) "
        f"{t[3] - t[2]:.1f} s, in all {t[3] - t[0]:.1f} s")
    return dict(encdec=encdec, vlm=vlm,
                seconds=dict(a=t[1] - t[0], b=t[2] - t[1], c=t[3] - t[2]))


# ---------------------------------------------------------------------------
# phase 15: the distributed layer (one card), and --dist-only (four)
# ---------------------------------------------------------------------------
DIST_CUT = 2            # (b): layers of the fp32 model held bit for bit
DIST_DECODE = 4         # decode steps of --dist-only's (b) and (c)
# --dist-only (b): the bf16 flash prefill on the (2, 2) mesh against one
# card's, of the largest |logit| (phase 6's bf16 gate for kernel vs plain;
# the partial sums of the sharded products round apart in bf16)
DIST_BF16_TOL = 5e-2
# --dist-only (c): a prefill's all-gathers over "data" against the local
# bytes of the weights that FSDP gathers (each once a prefill)
DIST_GATHER_TOL = 1e-2
DIST_TRAIN_STEPS = 2    # --dist-only (d): timed steps, after a warm-up
# (d) against one card from the same seed: the first step's loss within
# 1e-2 (relative) and its global gradient norm within 2 % in bf16; in fp32
# at HYBRID_CUT layers each gradient leaf within 1e-4 of its leaf's largest
# magnitude, the updated params within 1e-4 of the largest |param|
DIST_LOSS_TOL, DIST_NORM_TOL, DIST_FP32_TOL = 1e-2, 2e-2, 1e-4
# --dist-only (e): mixtral-8x7b prefilled whole on the (2, 2) mesh; (f):
# olmoe-1b-7b trained whole there, its bf16 first step held against one
# card's at MOE_REF_CUT layers (the whole state, ~83 GB, does not fit one
# card) and an fp32 step at MOE_FP32_CUT layers, both at full width
MOE_ARCH, MOE_TRAIN_ARCH = "mixtral-8x7b", "olmoe-1b-7b"
MOE_REF_CUT, MOE_FP32_CUT = 4, 2
FLASH_BUILD = ("flash_attention", "flash_attention_wgmma")
# compress_int8 on the card against the CPU: a size that is not a multiple
# of the 256-element block, several blocks, and a block of zeros
COMPRESS_SHAPES = ((1000,), (64, 256), (3, 7, 129))


def free_port() -> int:
    import socket
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


@contextlib.contextmanager
def world_one(dev):
    """A world-1 process group (NCCL on the card, gloo on the CPU; tcp on
    localhost), destroyed on exit."""
    import torch
    import torch.distributed as dist
    cuda = dev.type == "cuda"
    dist.init_process_group(
        "nccl" if cuda else "gloo",
        init_method=f"tcp://127.0.0.1:{free_port()}", rank=0, world_size=1,
        device_id=torch.device("cuda", torch.cuda.current_device())
        if cuda else None)
    try:
        yield
    finally:
        dist.destroy_process_group()


def _close(a, b, ulps: int, mag) -> bool:
    """|a - b| within `ulps` fp32 ulps of `mag` (e.g. the sum of the
    addends' magnitudes, which bounds a sum's rounding) everywhere."""
    import torch
    ulp = torch.where(mag > 0, torch.exp2(torch.floor(torch.log2(mag))
                                          - 23), torch.zeros_like(mag))
    return bool(((a - b).abs() <= ulps * ulp).all())


def compression_check(mesh, dev, world: int = 1) -> dict:
    """(a) `compress_int8` / `decompress_int8` on the card equal the CPU bit
    for bit (q, scales, values) at COMPRESS_SHAPES, one of them with a
    block of zeros; `compressed_allreduce` over the mesh's "data" axis of
    `world` ranks: ones sum to exactly `world`, seeded per-rank grads to
    the sum of every rank's decompression within 4 fp32 ulps of the
    addends' summed magnitude (the order of the sum is NCCL's), and the
    error feedback is each rank's residual."""
    import torch
    import torch.distributed as dist
    from repro_torch.optim import compression as C
    rank = dist.get_rank()
    out = {}
    for shape in COMPRESS_SHAPES:
        g = torch.from_numpy(np.random.default_rng(7).standard_normal(
            shape).astype(np.float32))
        if shape == (64, 256):
            g[3] = 0.0                      # an all-zero block
        qc, sc = C.compress_int8(g)
        qd, sd = C.compress_int8(g.to(dev))
        same = (torch.equal(qc, qd.cpu()) and torch.equal(sc, sd.cpu())
                and torch.equal(C.decompress_int8(qc, sc, shape,
                                                  torch.float32),
                                C.decompress_int8(qd, sd, shape,
                                                  torch.float32).cpu()))
        if not same:
            raise AssertionError(f"compress_int8 {shape}: card != CPU")
        out[str(shape)] = "card == cpu"
    grads = {"a": torch.ones((5, 300), device=dev),
             "b": torch.ones(7, device=dev, dtype=torch.bfloat16)}
    summed, err = C.compressed_allreduce(grads, (mesh, "data"))
    for name, v in summed.items():
        if not bool((v == world).all()):
            raise AssertionError(f"ones summed to {v.unique()} on {name}")

    def grad(r):
        g = np.random.default_rng(100 + r).standard_normal((3, 1000))
        return {"w": torch.from_numpy(g.astype(np.float32)).to(dev)}
    mine = grad(rank)
    red, new_err = C.compressed_allreduce(mine, (mesh, "data"))
    parts = [C.decompress_int8(*C.compress_int8(grad(r)["w"]), (3, 1000),
                               torch.float32) for r in range(world)]
    want = sum(parts)
    local = C.decompress_int8(*C.compress_int8(mine["w"]), (3, 1000),
                              torch.float32)
    if not _close(red["w"], want, 4, sum(p.abs() for p in parts)):
        raise AssertionError("compressed_allreduce: sum past 4 ulps, max "
                             f"{(red['w'] - want).abs().max().item()}")
    if not torch.equal(new_err["w"], mine["w"] - local):
        raise AssertionError("compressed_allreduce: error != residual")
    out["allreduce"] = dict(world=world, ones="exact", sum_max_err=(
        red["w"] - want).abs().max().item(), error="residual")
    log(f"phase 15 (a) compression over {world} rank(s): {out}")
    return out


def _vlm_batch(cfg, dev, b, s, seed):
    """A VLM prefill batch (patches + tokens) and its [3, b, s] grid
    positions."""
    return _prompts(cfg, dev, seed, b=b, s=s), \
        _grid_positions(cfg, dev, b=b, s=s)


def _sharded_prefill(model, params, batch, pos, mesh):
    """lm_forward (model's attn_impl) of the DTensor params on the batch
    and grid positions laid out by `shardings.py` (the positions' batch
    dim over "data")."""
    from torch.distributed.tensor.experimental import implicit_replication
    from repro_torch.launch import shardings as sh
    from repro_torch.models import transformer as T
    db = sh.distribute(batch, mesh, sh.batch_shardings(mesh, batch),
                       src_data_rank=None)
    dpos = sh.distribute_leaf(pos, mesh, sh.P(None, "data", None),
                              src_data_rank=None)
    with implicit_replication():
        return T.lm_forward(params, model.cfg, db["tokens"],
                            extra_embeds=db["extra_embeds"],
                            positions=dpos, attn_impl=model.attn_impl)[0]


def _sharded_decode(model, params, mesh, b, max_len, tokens):
    """Teacher-forced decode of tokens [b, n] from a fresh state laid out
    by `decode_state_shardings`: the DTensor logits of each step."""
    from torch.distributed.tensor.experimental import implicit_replication
    from repro_torch.launch import shardings as sh
    st = model.init_decode_state(b, max_len)
    st = sh.distribute(st, mesh, sh.decode_state_shardings(
        mesh, st, model.cfg), src_data_rank=None)
    out = []
    with implicit_replication():
        for t in range(tokens.shape[1]):
            tok = sh.distribute_leaf(tokens[:, t].contiguous(), mesh,
                                     sh.P("data"), src_data_rank=None)
            lg, st = model.decode_step(params, st, tok)
            out.append(lg)
    return out


def dist_vlm_small(mesh, dev, b=PREFILL_B, s=PREFILL_S, exact=True,
                   reduced=False):
    """qwen2-vl-72b at DIST_CUT layers (the reduced config with `reduced`),
    fp32 (TF32 off), blockwise attention: the prefill of DTensor params
    and inputs laid out by `shardings.py` against the plain-tensor
    prefill of the same weights (initialised whole on each card, then
    distributed), bit for bit with `exact` (a (1, 1) mesh), else within
    1e-4 of the largest |logit|; without `exact` also DIST_DECODE decode
    steps against the plain decode, to the same tolerance."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.launch import shardings as sh
    from repro_torch.models.model import Model
    import dataclasses
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = dataclasses.replace(get_config(VLM_ARCH, reduced=True),
                              dtype="float32") if reduced else \
        _cut(VLM_ARCH, layers=DIST_CUT, dtype="float32")
    model = Model(cfg, attn_impl="blockwise", device=str(dev))
    params = model.init(torch.Generator(device=dev).manual_seed(0))
    batch, pos = _vlm_batch(cfg, dev, b, s, seed=0)
    from repro_torch.models import transformer as T
    with torch.no_grad():
        plain = T.lm_forward(params, cfg, batch["tokens"],
                             extra_embeds=batch["extra_embeds"],
                             positions=pos)[0]
        dparams = sh.distribute(params, mesh, sh.param_shardings(
            mesh, params), src_data_rank=None)
        sharded = _sharded_prefill(model, dparams, batch, pos,
                                   mesh).full_tensor()
    err = (sharded - plain).abs().max().item()
    top = plain.abs().max().item()
    res = dict(layers=cfg.num_layers, batch=b, seq_len=s,
               mesh=list(mesh.shape), prefill_max_err=err,
               max_abs_logit=top, bit_for_bit=bool(torch.equal(sharded,
                                                              plain)))
    del sharded, plain
    if exact and not res["bit_for_bit"]:
        raise AssertionError(f"sharded prefill != plain: max {err}")
    if not exact and not err <= 1e-4 * top:
        raise AssertionError(f"sharded prefill: {err} > 1e-4 x {top}")
    if not exact:
        toks = batch["tokens"][:, :DIST_DECODE]
        with torch.no_grad():
            dec = _sharded_decode(model, dparams, mesh, b, 64, toks)
            ref = _decode_logits(model, params, toks)
        derr = max((d.full_tensor() - ref[:, i]).abs().max().item()
                   for i, d in enumerate(dec))
        dtop = ref.abs().max().item()
        res.update(decode_steps=DIST_DECODE, decode_max_err=derr,
                   decode_max_abs_logit=dtop)
        if not derr <= 1e-4 * dtop:
            raise AssertionError(f"sharded decode: {derr} > 1e-4 x {dtop}")
    log(f"phase 15 (b) {VLM_ARCH} {cfg.num_layers} layers fp32 on a "
        f"{tuple(mesh.shape)} mesh, B={b} S={s}: {res}")
    return res, params


def dist_flash_small(mesh, dev, dtype: str, tol, b=PREFILL_B, s=PREFILL_S,
                     reduced=False) -> dict:
    """qwen2-vl-72b at DIST_CUT layers (the reduced config with `reduced`)
    in `dtype` (TF32 off), attn_impl="flash": the prefill of DTensor
    params and inputs laid out by `shardings.py`, where each rank runs the
    flash kernel on its batch and head shard (`models/spmd.py`), against
    the plain-tensor prefill through the same kernel on this card; bit
    for bit with `tol` None, else within `tol` of the largest |logit|. On
    the card the sharded prefill launches the kernel exactly once a layer,
    bf16 on the tensor cores (the variant the shards' views must get) and
    fp32 on the CUDA cores."""
    import dataclasses
    import torch
    from repro_torch.configs import get_config
    from repro_torch.kernels import ops
    from repro_torch.launch import shardings as sh
    from repro_torch.models import transformer as T
    from repro_torch.models.model import Model
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = dataclasses.replace(get_config(VLM_ARCH, reduced=True),
                              dtype=dtype) if reduced else \
        _cut(VLM_ARCH, layers=DIST_CUT, dtype=dtype)
    model = Model(cfg, attn_impl="flash", device=str(dev))
    params = model.init(torch.Generator(device=dev).manual_seed(0))
    batch, pos = _vlm_batch(cfg, dev, b, s, seed=0)
    cuda = dev.type == "cuda"
    with torch.no_grad():
        plain = T.lm_forward(params, cfg, batch["tokens"],
                             extra_embeds=batch["extra_embeds"],
                             positions=pos, attn_impl="flash")[0]
        dparams = sh.distribute(params, mesh, sh.param_shardings(
            mesh, params), src_data_rank=None)
        del params
        if cuda:
            torch.cuda.synchronize()
        ops.reset_launches()
        sharded = _sharded_prefill(model, dparams, batch, pos, mesh)
        if cuda:
            torch.cuda.synchronize()
        launches, variants = dict(ops.launches), dict(ops.flash_variants)
        sharded = sharded.full_tensor()
    # on CPU tensors the wrapper runs the plain version: no launch
    _only(launches, {"flash_attention": cfg.num_layers if cuda else 0})
    want = ops.TENSOR_CORES if dtype == "bfloat16" else ops.CUDA_CORES
    if cuda and variants[want] != cfg.num_layers:
        raise AssertionError(f"sharded flash ran {variants}: want "
                             f"{cfg.num_layers} on {want}")
    err = (sharded.float() - plain.float()).abs().max().item()
    top = plain.float().abs().max().item()
    res = dict(layers=cfg.num_layers, dtype=dtype, batch=b, seq_len=s,
               mesh=list(mesh.shape), launches=launches["flash_attention"],
               variants={k: v for k, v in variants.items() if v},
               prefill_max_err=err, max_abs_logit=top, tolerance=tol,
               bit_for_bit=bool(torch.equal(sharded, plain)))
    del sharded, plain, dparams
    if tol is None and not res["bit_for_bit"]:
        raise AssertionError(f"sharded flash prefill != plain: max {err}")
    if tol is not None and not err <= tol * top:
        raise AssertionError(f"sharded flash prefill: {err} > {tol} x {top}")
    log(f"phase 15 (b) {VLM_ARCH} {cfg.num_layers} layers {dtype}, flash on "
        f"a {tuple(mesh.shape)} mesh, B={b} S={s}: {res}")
    return res


def dist_restore(mesh, dev) -> dict:
    """(c) (b)'s model in its published dtype (bf16 weights, fp32 norms;
    DIST_CUT layers, 8.5 GB) saved whole, then restored with its param
    specs on the mesh: every leaf equal to the saved one and laid out by
    its spec."""
    import shutil
    import tempfile
    import torch
    from repro_torch import tree as tree_lib
    from repro_torch.checkpoint import ckpt
    from repro_torch.launch import shardings as sh
    from repro_torch.launch.dryrun import spec_pairs
    from repro_torch.models.model import Model
    params = Model(_cut(VLM_ARCH, layers=DIST_CUT), device=str(dev)).init(
        torch.Generator(device=dev).manual_seed(0))
    specs = sh.param_shardings(mesh, params)
    root = tempfile.mkdtemp(prefix="chip_smoke_dist_")
    try:
        t0 = time.perf_counter()
        ckpt.save(root, 1, params)
        t1 = time.perf_counter()
        got = ckpt.restore(root, 1, params, shardings=specs, mesh=mesh)
        t2 = time.perf_counter()
    finally:
        shutil.rmtree(root, ignore_errors=True)
    names, restored = tree_lib.flatten_with_paths(got)
    bad = [n for n, a, (b, spec) in zip(names, restored,
                                        spec_pairs(params, specs))
           if not (torch.equal(a.full_tensor(), b)
                   and a.placements == sh.placements(mesh, spec))]
    if bad:
        raise AssertionError(f"restored leaves differ: {bad[:5]}")
    res = dict(leaves=len(list(_leaves(params))), save_s=t1 - t0,
               restore_s=t2 - t1, equal=True)
    log(f"phase 15 (c) restore with placements: {res}")
    return res


def dist_path(dev):
    """Phase 15 on one card: a world-1 NCCL group and the (1, 1) host
    mesh; (a) `compression_check`, (b) `dist_vlm_small` and, in bf16,
    `dist_flash_small` bit for bit, (c) `dist_restore`."""
    import torch
    from repro_torch.launch.mesh import make_host_mesh
    t0 = time.perf_counter()
    with world_one(dev):
        mesh = make_host_mesh(device_type=dev.type)
        out = dict(mesh=list(mesh.shape))
        out["compression"] = compression_check(mesh, dev)
        out["prefill"], params = dist_vlm_small(mesh, dev)
        del params
        torch.cuda.empty_cache()
        out["flash"] = dist_flash_small(mesh, dev, "bfloat16", None)
        torch.cuda.empty_cache()
        out["restore"] = dist_restore(mesh, dev)
        torch.cuda.empty_cache()
    out["seconds"] = time.perf_counter() - t0
    log(f"phase 15 in {out['seconds']:.1f} s")
    return out


def _collectives(fn, mesh):
    """fn()'s result and the collectives DTensor and the port issued in it
    on this rank (`dryrun.cost_mode`): {"ops": n, "bytes": {kind: operand
    bytes}, "by_axis": {"<kind> over <mesh axis>": {"ops", "bytes"}},
    "shapes": [(kind, operand shape, mesh axis)]}."""
    from repro_torch.launch import dryrun
    with dryrun.counting(dryrun.cost_mode(mesh)) as cost:
        out = fn()
    return out, dict(ops=cost.collective_ops, bytes={
        k: v for k, v in cost.collective_kinds.items() if v},
        by_axis=cost.collective_axes, shapes=cost.collective_shapes)


def _over(coll, kind: str, axes) -> int:
    """Operand bytes of `coll`'s (`_collectives`) collectives of `kind`
    whose group spans any of the mesh axes `axes`."""
    return sum(c["bytes"] for label, c in coll["by_axis"].items()
               if label.split(" over ")[0] == kind
               and set(label.split(" over ")[1].split("+")) & set(axes))


def _rank_profile(fn) -> dict:
    """fn() once under torch.profiler on this rank; every rank calls it
    once, and a trace that is not whole (`trace_events`) is reported as
    such, not taken again (a retake on one rank would unpair the
    collectives): the wall ms, the device's busy share of it, device ms
    by kind (NCCL kernels, GEMMs: cuBLAS / CUTLASS kernels, the rest;
    streams overlap, so the kinds may sum past the busy time) and the
    kernel count."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        open_trace()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
        close_trace()
    events, whole = trace_events(prof)
    dev = [e for e in events
           if e.device_type == torch.autograd.DeviceType.CUDA]
    kinds = collections.Counter()
    for e in dev:
        name = e.name.lower()
        kind = "nccl" if "nccl" in name else "gemm" if any(
            k in name for k in ("gemm", "xmma", "cutlass", "nvjet")) \
            else "other"
        kinds[kind] += e.time_range.elapsed_us() / 1e3
    busy = _busy_us([(e.time_range.start, e.time_range.end)
                     for e in dev]) / 1e3
    return dict(wall_ms=wall_ms, busy_share=busy / wall_ms,
                device_ms=dict(kinds), kernels=len(dev), whole=whole)


def dist_full(mesh, dev, reduced=False, b=PREFILL_B, s=PREFILL_S):
    """--dist-only (c): qwen2-vl-72b at all its layers, bf16, every matrix
    split over both axes of the (2, 2) mesh by the sharding rules, and
    FSDP x TP as they define it: each layer's weights gathered over
    "data" where the layer starts (`spmd.gather_weights`), its "model"
    shards kept. The weights drawn leaf by leaf on every rank from a
    generator seeded 0, each rank keeping its shard (`param_placer`);
    prefill of b x s (patches + tokens, [3, B, S] grid positions) with
    attn_impl="flash" as phase 14 (b) (each rank launches the kernel on
    its batch and head shard: exactly one launch a layer, on the tensor
    cores), timed after a warm-up, finite logits; DIST_DECODE decode
    steps from an empty cache of s + 8 slots, timed; each card's peak
    memory; the collectives of one prefill and of one decode step by kind
    and mesh axis, gated on every card: no all-reduce over the data axes
    in the prefill, and its all-gathers over "data" within 1 % of the
    local bytes of the data-sharded weights
    (`dryrun.gathered_bytes_analytic`); one more prefill profiled on
    every card (`_rank_profile`)."""
    import torch
    import torch.distributed as dist
    from repro_torch.configs import get_config
    from repro_torch.kernels import ops
    from repro_torch.launch import dryrun
    from repro_torch.launch import shardings as sh
    from repro_torch.launch.mesh import data_axes
    from repro_torch.models.model import Model
    cfg = get_config(VLM_ARCH, reduced=reduced)
    model = Model(cfg, attn_impl="flash", device=str(dev))
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = model.init(torch.Generator(device=dev).manual_seed(0),
                        place=sh.param_placer(mesh))
    if dev.type == "cuda":
        torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    n_params = sum(p.numel() for p in _leaves(params))
    local_bytes = sum(p.to_local().numel() * p.element_size()
                      for p in _leaves(params))
    batch, pos = _vlm_batch(cfg, dev, b, s, seed=0)

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize()
        dist.barrier()
    walls = []
    with torch.no_grad():
        for _ in range(2):
            sync()
            ops.reset_launches()
            t1 = time.perf_counter()
            logits = _sharded_prefill(model, params, batch, pos, mesh)
            sync()
            walls.append((time.perf_counter() - t1) * 1e3)
            # on CPU tensors the wrapper runs the plain version: no launch
            _only(dict(ops.launches), {"flash_attention": cfg.num_layers
                                       if dev.type == "cuda" else 0})
            if dev.type == "cuda" and \
                    ops.flash_variants[ops.TENSOR_CORES] != cfg.num_layers:
                raise AssertionError(f"flash variants {ops.flash_variants}"
                                     f": want {cfg.num_layers} on "
                                     f"{ops.TENSOR_CORES}")
            finite = torch.isfinite(logits.to_local()).all().float()
            del logits
        dist.all_reduce(finite, op=dist.ReduceOp.MIN)
        if finite.item() != 1.0:
            raise AssertionError("80-layer prefill logits are not finite")
        _, coll_prefill = _collectives(lambda: _sharded_prefill(
            model, params, batch, pos, mesh), mesh)
        coll_prefill.pop("shapes")
        fsdp = dict(all_reduce_over_data=_over(coll_prefill, "all-reduce",
                                               data_axes(mesh)),
                    all_gather_over_data=_over(coll_prefill, "all-gather",
                                               ("data",)),
                    weights_gathered=dryrun.gathered_bytes_analytic(
                        params, mesh))
        fsdp["ok"] = fsdp["all_reduce_over_data"] == 0 and abs(
            fsdp["all_gather_over_data"] - fsdp["weights_gathered"]) <= \
            DIST_GATHER_TOL * fsdp["weights_gathered"]
        every = [None] * dist.get_world_size()
        dist.all_gather_object(every, fsdp)
        if not all(f["ok"] for f in every):
            raise AssertionError(f"prefill collectives are not FSDP x TP: "
                                 f"{every}")
        profiles = [None] * dist.get_world_size()
        if dev.type == "cuda":
            dist.all_gather_object(profiles, _rank_profile(
                lambda: _sharded_prefill(model, params, batch, pos, mesh)))
        toks = batch["tokens"][:, :DIST_DECODE + 1]
        steps = []
        st = model.init_decode_state(b, s + 8)
        st = sh.distribute(st, mesh, sh.decode_state_shardings(
            mesh, st, cfg), src_data_rank=None)
        from torch.distributed.tensor.experimental import \
            implicit_replication
        with implicit_replication():
            for t in range(DIST_DECODE + 1):
                tok = sh.distribute_leaf(toks[:, t].contiguous(), mesh,
                                         sh.P("data"), src_data_rank=None)
                sync()
                t1 = time.perf_counter()
                if t < DIST_DECODE:
                    lg, st = model.decode_step(params, st, tok)
                else:
                    (lg, st), coll_decode = _collectives(
                        lambda: model.decode_step(params, st, tok), mesh)
                    coll_decode.pop("shapes")
                sync()
                steps.append((time.perf_counter() - t1) * 1e3)
                ok = torch.isfinite(lg.to_local()).all().float()
                dist.all_reduce(ok, op=dist.ReduceOp.MIN)
                if ok.item() != 1.0:
                    raise AssertionError("decode logits are not finite")
    peak = torch.cuda.max_memory_allocated() if dev.type == "cuda" else 0
    peaks = [None] * dist.get_world_size()
    dist.all_gather_object(peaks, peak)
    res = dict(
        arch=VLM_ARCH, layers=cfg.num_layers, dtype=cfg.dtype,
        mesh=list(mesh.shape), params=n_params,
        weight_bytes_per_card=local_bytes, init_s=init_s, batch=b,
        seq_len=s, ms_per_prefill=walls[-1], prefill_runs_ms=walls,
        tokens_per_s=b * s / (walls[-1] / 1e3),
        ms_per_decode_step=sum(steps[1:DIST_DECODE]) / (DIST_DECODE - 1),
        decode_steps_ms=steps[:DIST_DECODE], decode_cache_slots=s + 8,
        peak_memory_bytes=peaks, prefill_profile_by_rank=profiles,
        collectives_prefill=coll_prefill, fsdp_by_rank=every,
        collectives_decode_step=coll_decode)
    log(f"--dist-only (c) {VLM_ARCH} {cfg.num_layers} layers {cfg.dtype}, "
        f"{n_params / 1e9:.2f} B params, {local_bytes / 2 ** 30:.2f} GiB a "
        f"card: {json.dumps(res, default=str)}")
    return res


def _counts_by_layer(aux) -> list:
    """The per-layer expert counts of a forward's aux, whole."""
    c = aux["expert_counts_per_layer"]
    return (c.full_tensor() if hasattr(c, "full_tensor") else c).tolist()


def dist_moe_small(mesh, dev, dtype: str, reduced=False, b=PREFILL_B,
                   s=PREFILL_S) -> dict:
    """(e) at DIST_CUT layers and full width (the reduced config with
    `reduced`) in `dtype` (TF32 off), attn_impl "flash": the prefill of
    DTensor params and tokens laid out by the rules against the plain
    prefill of the same weights on this card. fp32: every layer's expert
    counts equal, the logits within DIST_FP32_TOL of the largest |logit|;
    bf16: every routing flip of the first layer (a token whose top-k
    experts differ; its router input differs from the plain one by the
    rounding of the attention's TP sum alone) explained by that rounding:
    the plain path's gap between its k-th and (k+1)-th gates no larger
    than twice the token's largest gate difference between the two
    paths; the later layers' flips and count moves and the worst logit
    error printed, without a gate (the TP sums round apart in bf16, and a
    flip moves a token's output by far more than rounding)."""
    import dataclasses
    import torch
    from repro_torch.configs import get_config
    from repro_torch.launch import shardings as sh
    from repro_torch.models import transformer as T
    from repro_torch.models.model import Model
    from torch.distributed.tensor.experimental import implicit_replication
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = dataclasses.replace(get_config(MOE_ARCH, reduced=True),
                              dtype=dtype) if reduced else \
        _cut(MOE_ARCH, layers=DIST_CUT, dtype=dtype)
    model = Model(cfg, attn_impl="flash", device=str(dev))
    params = model.init(torch.Generator(device=dev).manual_seed(0))
    batch = _prompts(cfg, dev, seed=0, b=b, s=s)
    rec, drec = [], []
    with torch.no_grad():
        with _routing(record=rec):
            plain, aux = T.lm_forward(params, cfg, batch["tokens"],
                                      attn_impl="flash")
        dparams = sh.distribute(params, mesh, sh.param_shardings(
            mesh, params), src_data_rank=None)
        db = sh.distribute(batch, mesh, sh.batch_shardings(mesh, batch),
                           src_data_rank=None)
        with implicit_replication(), _routing(record=drec):
            dlogits, daux = T.lm_forward(dparams, cfg, db["tokens"],
                                         attn_impl="flash")
        sharded = dlogits.full_tensor()
    counts, dcounts = _counts_by_layer(aux), _counts_by_layer(daux)
    moves = [sum(abs(x - y) for x, y in zip(a, c)) // 2
             for a, c in zip(counts, dcounts)]
    # each layer's flips among this rank's tokens (its batch shard: the
    # rows of the plain routing its data index holds), with the plain
    # path's gate gaps
    k = cfg.experts_per_token
    rows = b * s // mesh.size(0)
    first = mesh.get_local_rank("data") * rows
    flips = []
    for (g, _, e), (dg, _, de) in zip(rec, drec):
        g, e = g[first:first + rows], e[first:first + rows]
        flip = (e.sort(-1).values != de.sort(-1).values).any(-1)
        top_g = g.sort(-1, descending=True).values
        moved = (dg - g).abs().max(-1).values
        flips.append(list(zip((top_g[:, k - 1] - top_g[:, k])[flip].tolist(),
                              moved[flip].tolist())))
    every = [None] * torch.distributed.get_world_size()
    torch.distributed.all_gather_object(every, flips)
    # the model ranks of one data index hold the same tokens
    flips = [sum((f[layer] for r, f in enumerate(every)
                  if r % mesh.size(1) == 0), [])
             for layer in range(cfg.num_layers)]
    err = (sharded.float() - plain.float()).abs().max().item()
    top = plain.float().abs().max().item()
    res = dict(arch=MOE_ARCH, layers=cfg.num_layers, dtype=dtype, batch=b,
               seq_len=s, mesh=list(mesh.shape), max_err=err,
               max_abs_logit=top, count_moves_per_layer=moves,
               counts_equal=[a == c for a, c in zip(counts, dcounts)],
               flips_per_layer=[len(f) for f in flips],
               first_layer_flips_gap_and_gate_moved=sorted(flips[0]))
    del sharded, plain, dlogits, dparams, params
    log(f"--dist-only (e) {MOE_ARCH} {cfg.num_layers} layers {dtype} on a "
        f"{tuple(mesh.shape)} mesh vs one card: {res}")
    if dtype == "float32" and not (all(res["counts_equal"])
                                   and err <= DIST_FP32_TOL * top):
        raise AssertionError(f"fp32 sharded MoE prefill off the plain "
                             f"one: {res}")
    if dtype != "float32" and any(gap > 2 * moved
                                  for gap, moved in flips[0]):
        raise AssertionError(f"bf16 sharded MoE prefill: a first-layer "
                             f"flip its gates' rounding cannot explain: "
                             f"{res}")
    return res


def dist_moe_full(mesh, dev, reduced=False, b=PREFILL_B, s=PREFILL_S):
    """--dist-only (e): mixtral-8x7b at all its layers, bf16, on the (2, 2)
    mesh with FSDP x TP and the MoE dispatch partitioned (each rank routes
    its own tokens, gathers only the routing over "data", exchanges slot
    rows by all-to-all): weights drawn leaf by leaf (seed 0, each rank its
    shard), a b x s prefill with attn_impl "flash" (one launch a layer on
    every card, on its batch and head shard, on the tensor cores), timed
    after a warm-up, finite logits; its collectives by kind and axis,
    gated on every card: no all-reduce over the data axes, and all-gathers
    over "data" within DIST_GATHER_TOL of the weights' local bytes
    (`dryrun.gathered_bytes_analytic`) plus the routing's (the gates
    [T/2, E] fp32 and ids [T/2, k] int32 of each layer): no token's
    hidden vector and no expert row gathered; one more
    prefill profiled on every card; DIST_DECODE decode steps from an
    empty cache, timed; each card's peak memory."""
    import torch
    import torch.distributed as dist
    from torch.distributed.tensor.experimental import implicit_replication
    from repro_torch.configs import get_config
    from repro_torch.kernels import ops
    from repro_torch.launch import dryrun
    from repro_torch.launch import shardings as sh
    from repro_torch.launch.mesh import data_axes
    from repro_torch.models import transformer as T
    from repro_torch.models.model import Model
    cfg = get_config(MOE_ARCH, reduced=reduced)
    cuda = dev.type == "cuda"
    model = Model(cfg, attn_impl="flash", device=str(dev))
    if cuda:
        torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = model.init(torch.Generator(device=dev).manual_seed(0),
                        place=sh.param_placer(mesh))
    if cuda:
        torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    n_params = sum(p.numel() for p in _leaves(params))
    local_bytes = sum(p.to_local().numel() * p.element_size()
                      for p in _leaves(params))
    batch = _prompts(cfg, dev, seed=0, b=b, s=s)
    db = sh.distribute(batch, mesh, sh.batch_shardings(mesh, batch),
                       src_data_rank=None)

    def prefill():
        with implicit_replication():
            return T.lm_forward(params, cfg, db["tokens"],
                                attn_impl="flash")[0]

    def sync():
        if cuda:
            torch.cuda.synchronize()
        dist.barrier()
    walls = []
    with torch.no_grad():
        for _ in range(2):
            sync()
            ops.reset_launches()
            t1 = time.perf_counter()
            logits = prefill()
            sync()
            walls.append((time.perf_counter() - t1) * 1e3)
            launches = dict(ops.launches)
            _only(launches, {"flash_attention": cfg.num_layers
                             if cuda else 0})
            if cuda and ops.flash_variants[ops.TENSOR_CORES] != \
                    cfg.num_layers:
                raise AssertionError(f"flash variants {ops.flash_variants}"
                                     f": want {cfg.num_layers} on "
                                     f"{ops.TENSOR_CORES}")
            finite = torch.isfinite(logits.to_local()).all().float()
            del logits
        dist.all_reduce(finite, op=dist.ReduceOp.MIN)
        if finite.item() != 1.0:
            raise AssertionError("MoE prefill logits are not finite")
        _, coll = _collectives(prefill, mesh)
        t_local = b * s // mesh.size(0)
        routing = cfg.num_layers * t_local * (cfg.num_experts
                                              + cfg.experts_per_token) * 4
        gathered = _over(coll, "all-gather", ("data",))
        fsdp = dict(all_reduce_over_data=_over(coll, "all-reduce",
                                               data_axes(mesh)),
                    all_gather_over_data=gathered,
                    weights_gathered=dryrun.gathered_bytes_analytic(
                        params, mesh),
                    routing_bytes=routing,
                    all_to_all_over_data=_over(coll, "all-to-all",
                                               data_axes(mesh)),
                    largest_all_to_all_rows=max(
                        [shape[0] for kind, shape, _ in coll.pop("shapes")
                         if kind == "all-to-all"], default=0))
        fsdp["ok"] = fsdp["all_reduce_over_data"] == 0 and abs(
            gathered - fsdp["weights_gathered"] - routing) <= \
            DIST_GATHER_TOL * fsdp["weights_gathered"]
        every = [None] * dist.get_world_size()
        dist.all_gather_object(every, fsdp)
        if not all(f["ok"] for f in every):
            raise AssertionError(f"MoE prefill collectives: {every}")
        profiles = [None] * dist.get_world_size()
        if cuda:
            dist.all_gather_object(profiles, _rank_profile(prefill))
        toks = batch["tokens"][:, :DIST_DECODE + 1]
        steps = []
        st = model.init_decode_state(b, s + 8)
        st = sh.distribute(st, mesh, sh.decode_state_shardings(
            mesh, st, cfg), src_data_rank=None)
        with implicit_replication():
            for t in range(DIST_DECODE + 1):
                tok = sh.distribute_leaf(toks[:, t].contiguous(), mesh,
                                         sh.P("data"), src_data_rank=None)
                sync()
                t1 = time.perf_counter()
                if t < DIST_DECODE:
                    lg, st = model.decode_step(params, st, tok)
                else:
                    (lg, st), coll_decode = _collectives(
                        lambda: model.decode_step(params, st, tok), mesh)
                    coll_decode.pop("shapes")
                sync()
                steps.append((time.perf_counter() - t1) * 1e3)
                ok = torch.isfinite(lg.to_local()).all().float()
                dist.all_reduce(ok, op=dist.ReduceOp.MIN)
                if ok.item() != 1.0:
                    raise AssertionError("decode logits are not finite")
    peak = torch.cuda.max_memory_allocated() if cuda else 0
    peaks = [None] * dist.get_world_size()
    dist.all_gather_object(peaks, peak)
    res = dict(
        arch=MOE_ARCH, layers=cfg.num_layers, dtype=cfg.dtype,
        mesh=list(mesh.shape), params=n_params,
        weight_bytes_per_card=local_bytes, init_s=init_s, batch=b,
        seq_len=s, ms_per_prefill=walls[-1], prefill_runs_ms=walls,
        tokens_per_s=b * s / (walls[-1] / 1e3), launches=launches,
        ms_per_decode_step=sum(steps[1:DIST_DECODE]) / (DIST_DECODE - 1),
        decode_steps_ms=steps[:DIST_DECODE], decode_cache_slots=s + 8,
        peak_memory_bytes=peaks, prefill_profile_by_rank=profiles,
        collectives_prefill=coll, fsdp_by_rank=every,
        collectives_decode_step=coll_decode)
    log(f"--dist-only (e) {MOE_ARCH} {cfg.num_layers} layers {cfg.dtype}, "
        f"{n_params / 1e9:.2f} B params, {local_bytes / 2 ** 30:.2f} GiB a "
        f"card: {json.dumps(res, default=str)}")
    return res


def _item(x) -> float:
    """A 0-d tensor's value (a DTensor's whole value)."""
    return (x.full_tensor() if hasattr(x, "full_tensor") else x).item()


def _layout_matches(mesh, params, tree) -> list:
    """The paths of `tree`'s leaves (gradients or AdamW's m / v, in
    `params`' structure) not laid out as the sharding rules' `opt_shardings`
    lay out AdamW's state."""
    from repro_torch import tree as tree_lib
    from repro_torch.launch import shardings as sh
    from repro_torch.launch.dryrun import spec_pairs
    o_sh = sh.opt_shardings(mesh, None, sh.param_shardings(mesh, params))
    names = tree_lib.flatten_with_paths(params)[0]
    return [n for n, (x, spec) in zip(names, spec_pairs(tree, o_sh["m"]))
            if tuple(x.placements) != sh.placements(mesh, spec)]


def _sharded_batch(tr, step: int, mesh):
    """The trainer's batch of `step`, laid out by `batch_shardings`."""
    from repro_torch.launch import shardings as sh
    batch = tr.data.batch_at(step)
    return sh.distribute(batch, mesh, sh.batch_shardings(mesh, batch),
                         src_data_rank=None)


def dist_train_fp32(mesh, dev, arch, reduced, b, s, ckpt_dir,
                    layers=HYBRID_CUT) -> dict:
    """(d) and (f) in fp32 (TF32 off) at `layers` layers of full width
    (zamba2's HYBRID_CUT: two groups; the reduced config with `reduced`):
    one `Trainer` step's gradients
    (`loss_and_grads`) and AdamW update of the params laid out by the
    sharding rules against the same step of the plain params on this
    card: each gradient leaf within DIST_FP32_TOL of its leaf's largest
    magnitude, the updated params within DIST_FP32_TOL of the largest
    |param| (AdamW's first step moves an element by lr * g / (|g| +
    eps): where g is near zero the two sides' rounding moves it
    differently by up to 2 lr, which a leaf initialised at zero, a norm
    scale, cannot be held to relative to itself; the per-leaf worst is
    reported), every gradient laid out as its AdamW state."""
    import dataclasses
    import torch
    from torch.distributed.tensor.experimental import implicit_replication
    from repro_torch import tree as tree_lib
    from repro_torch.configs import get_config
    from repro_torch.launch import shardings as sh
    from repro_torch.models.model import Model
    from repro_torch.optim import adamw
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = dataclasses.replace(get_config(arch, reduced=True),
                              dtype="float32") if reduced else \
        _cut(arch, layers=layers, dtype="float32")
    model = Model(cfg, attn_impl="blockwise", remat="full", device=str(dev))
    tr = _trainer(model, b, s, 1, ckpt_dir)
    plain = model.init(torch.Generator(device=dev).manual_seed(0))
    # a copy: a replicated DTensor's local tensor may be the plain leaf,
    # which the plain update writes in place
    dparams = sh.distribute(tree_lib.map_leaves(torch.clone, plain), mesh,
                            sh.param_shardings(mesh, plain),
                            src_data_rank=None)
    loss, grads = tr.loss_and_grads(plain, tr.data.batch_at(0))
    adamw.adamw_update(tr.opt_cfg, plain, grads, adamw.adamw_init(plain))
    with implicit_replication():
        dloss, dgrads = tr.loss_and_grads(dparams, _sharded_batch(tr, 0,
                                                                  mesh))
        misplaced = _layout_matches(mesh, dparams, dgrads)
        adamw.adamw_update(tr.opt_cfg, dparams, dgrads,
                           adamw.adamw_init(dparams))
    names = tree_lib.flatten_with_paths(plain)[0]

    def worst(xs, ds):
        """(worst error over its leaf's largest magnitude, that leaf,
        worst error over the tree's largest magnitude)."""
        out, err_all, top_all = (0.0, None), 0.0, 0.0
        for n, x, d in zip(names, tree_lib.leaves(xs), tree_lib.leaves(ds)):
            err = (d.full_tensor() - x).abs().max().item()
            top = x.abs().max().item()
            rel = err / top if top else (0.0 if err == 0 else float("inf"))
            out = max(out, (rel, n))
            err_all, top_all = max(err_all, err), max(top_all, top)
        return out + (err_all / top_all,)
    g_rel, g_leaf, _ = worst(grads, dgrads)
    p_leaf_rel, p_leaf, p_rel = worst(plain, dparams)
    res = dict(layers=cfg.num_layers, batch=b, seq_len=s,
               loss=loss.item(), sharded_loss=_item(dloss),
               grad_worst_rel=g_rel, grad_worst_leaf=g_leaf,
               param_worst_rel=p_rel, param_leaf_worst_rel=p_leaf_rel,
               param_worst_leaf=p_leaf, tolerance=DIST_FP32_TOL,
               leaves=len(names), misplaced_grads=misplaced)
    log(f"--dist-only fp32 {arch} {cfg.num_layers} layers, B={b} "
        f"S={s}: {res}")
    if misplaced:
        raise AssertionError(f"gradients not laid out as AdamW's state: "
                             f"{misplaced[:5]}")
    if not (g_rel <= DIST_FP32_TOL and p_rel <= DIST_FP32_TOL):
        raise AssertionError(f"fp32 sharded step off the plain one: {res}")
    return res


def _logit_gathers(shapes, b_local: int, s: int, v_local: int) -> list:
    """The all-gathers in `shapes` (`_collectives`) of a card's logits, an
    operand of [b_local, s, v_local]'s size: the gather the vocab-parallel
    loss avoids."""
    return [(kind, shape, axis) for kind, shape, axis in shapes
            if kind == "all-gather"
            and int(np.prod(shape)) == b_local * s * v_local]


def _first_step(cfg, mesh, dev, b, s, ckpt_dir) -> dict:
    """The first `Trainer` step (remat "full") of `cfg` from seed 0: on
    DTensors laid out by the rules with `mesh`, else on this card's plain
    tensors; its loss and global gradient norm."""
    import torch
    from torch.distributed.tensor.experimental import implicit_replication
    from repro_torch.launch import shardings as sh
    from repro_torch.models.model import Model
    from repro_torch.optim import adamw
    model = Model(cfg, attn_impl="blockwise", remat="full", device=str(dev))
    tr = _trainer(model, b, s, 1, ckpt_dir)
    gen = torch.Generator(device=dev).manual_seed(0)
    if mesh is None:
        one = model.init(gen)
        _, _, m = tr.train_step(one, adamw.adamw_init(one),
                                tr.data.batch_at(0))
    else:
        one = model.init(gen, place=sh.param_placer(mesh))
        with implicit_replication():
            _, _, m = tr.train_step(one, adamw.adamw_init(one),
                                    _sharded_batch(tr, 0, mesh))
    return dict(layers=cfg.num_layers, loss=_item(m["loss"]),
                grad_norm=_item(m["grad_norm"]))


def dist_train(mesh, dev, reduced=False, arch="zamba2-2.7b",
               ref_layers=None, fp32_layers=HYBRID_CUT) -> dict:
    """--dist-only (d) (zamba2-2.7b) and (f) (`arch` olmoe-1b-7b): `arch`
    at full size (the reduced config with `reduced`), bf16, remat "full",
    attn_impl "blockwise", B=TRAIN_B x S=TRAIN_S, trained on the (2, 2)
    mesh: params drawn by `param_placer` (seed 0), AdamW's state by
    `adamw_init` (its placements `opt_shardings`'), each batch by
    `batch_shardings`; one warm-up step (`Trainer.loss_and_grads`, then
    `adamw_update`: `train_step`'s two halves) with its collectives counted
    by kind and mesh axis, none of them an all-gather of a card's logits
    (the loss works on each rank's vocab shard), and every gradient
    laid out as its AdamW state (the weights' gradients reduce-scattered
    over "data", no all-reduce of whole gradients), then DIST_TRAIN_STEPS
    timed `Trainer.train_step`s and one profiled on every card; on the
    card exactly 2 mamba_scan and 1 mamba_scan_bwd launches a mamba block
    a step on every card (each on its batch and head shard) and nothing
    else. Then, the sharded state freed, the first step from the same seed
    on one card's plain tensors (rank 0; the others wait): its loss within
    DIST_LOSS_TOL (relative) and global gradient norm within DIST_NORM_TOL
    of the sharded step's; at `ref_layers` layers for both where the whole
    state does not fit one card. Last `dist_train_fp32` at `fp32_layers`
    layers."""
    import gc
    import shutil
    import tempfile
    import torch
    import torch.distributed as dist
    from torch.distributed.tensor.experimental import implicit_replication
    from repro_torch.configs import get_config
    from repro_torch.kernels import ops
    from repro_torch.launch import dryrun
    from repro_torch.launch import shardings as sh
    from repro_torch.launch.mesh import data_axes
    from repro_torch.models.model import Model
    from repro_torch.optim import adamw
    cuda = dev.type == "cuda"
    cfg = get_config(arch, reduced=reduced)
    b, s = (2, 64) if reduced else (TRAIN_B, TRAIN_S)
    n_ssm = _n_blocks(cfg, "ssm")
    # on CPU tensors the wrappers run their plain versions: no launch
    want = {"mamba_scan": 2 * n_ssm, "mamba_scan_bwd": n_ssm} if cuda \
        else {}
    model = Model(cfg, attn_impl="blockwise", remat="full", device=str(dev))
    ckpt_dir = tempfile.mkdtemp(prefix="chip_smoke_dist_train_")

    def sync():
        if cuda:
            torch.cuda.synchronize()
        dist.barrier()
    try:
        tr = _trainer(model, b, s, DIST_TRAIN_STEPS + 2, ckpt_dir)
        if cuda:
            torch.cuda.reset_peak_memory_stats()
        params = model.init(torch.Generator(device=dev).manual_seed(0),
                            place=sh.param_placer(mesh))
        opt = adamw.adamw_init(params)
        misplaced = _layout_matches(mesh, params, opt["m"]) + \
            _layout_matches(mesh, params, opt["v"])
        if misplaced:
            raise AssertionError(f"AdamW state not laid out by "
                                 f"opt_shardings: {misplaced[:5]}")
        walls, launches = [], []
        for step in range(DIST_TRAIN_STEPS + 1):
            db = _sharded_batch(tr, step, mesh)
            sync()
            ops.reset_launches()
            t0 = time.perf_counter()
            with implicit_replication():
                if step == 0:
                    def warm():
                        loss, grads = tr.loss_and_grads(params, db)
                        m = adamw.adamw_update(tr.opt_cfg, params, grads,
                                               opt)[2]
                        return loss, grads, m
                    (loss, grads, metrics), coll = _collectives(warm,
                                                                mesh)
                    misplaced = _layout_matches(mesh, params, grads)
                    del grads
                    first = dict(loss=_item(loss),
                                 grad_norm=_item(metrics["grad_norm"]))
                else:
                    _, _, metrics = tr.train_step(params, opt, db)
                    _item(metrics["loss"])      # the step's host sync
            sync()
            walls.append((time.perf_counter() - t0) * 1e3)
            launches.append(dict(ops.launches))
            _only(launches[-1], want)
        if misplaced:
            raise AssertionError(f"gradients not laid out as AdamW's "
                                 f"state: {misplaced[:5]}")
        shapes = coll.pop("shapes")
        logit_gathers = _logit_gathers(shapes, b // mesh.size(0), s,
                                       -(-cfg.vocab_size // mesh.size(1)))
        if logit_gathers:
            raise AssertionError(f"the step gathers the logits: "
                                 f"{logit_gathers}")
        gather = dryrun.gathered_bytes_analytic(params, mesh)
        profiles = [None] * dist.get_world_size()
        if cuda:
            db = _sharded_batch(tr, DIST_TRAIN_STEPS + 1, mesh)

            def profiled():
                with implicit_replication():
                    tr.train_step(params, opt, db)
            dist.all_gather_object(profiles, _rank_profile(profiled))
        peak = torch.cuda.max_memory_allocated() if cuda else 0
        peaks = [None] * dist.get_world_size()
        dist.all_gather_object(peaks, peak)
        del params, opt, db, metrics, loss
        gc.collect()
        if cuda:
            torch.cuda.empty_cache()
        ref_cfg = cfg if ref_layers is None or reduced else \
            _cut(arch, layers=ref_layers)
        if ref_layers is not None:
            # the whole state does not fit one card: the sharded side of
            # the comparison at ref_layers layers too
            first = _first_step(ref_cfg, mesh, dev, b, s, ckpt_dir)
            gc.collect()
            if cuda:
                torch.cuda.empty_cache()
        ref = [None]
        if dist.get_rank() == 0:
            if cuda:
                torch.cuda.reset_peak_memory_stats()
            ref = [_first_step(ref_cfg, None, dev, b, s, ckpt_dir)]
            ref[0]["peak_memory_bytes"] = \
                torch.cuda.max_memory_allocated() if cuda else 0
            gc.collect()
            if cuda:
                torch.cuda.empty_cache()
        dist.broadcast_object_list(ref, src=0)
        ref = ref[0]
    finally:
        shutil.rmtree(ckpt_dir, ignore_errors=True)
    ms = sum(walls[1:]) / DIST_TRAIN_STEPS
    res = dict(
        arch=arch, layers=cfg.num_layers, dtype=cfg.dtype, remat="full",
        mesh=list(mesh.shape), batch=b, seq_len=s,
        steps_ms=walls, ms_per_step=ms, train_tok_per_s=b * s / ms * 1e3,
        launches_per_step=launches, peak_memory_bytes=peaks,
        profile_by_rank=profiles, collectives_step=coll,
        weights_gathered_once=gather,
        all_reduce_over_data=_over(coll, "all-reduce", data_axes(mesh)),
        largest_all_gather=max([(int(np.prod(shape)), shape, axis)
                                for kind, shape, axis in shapes
                                if kind == "all-gather"], default=None),
        first_step=first, one_card=ref,
        loss_rel_err=abs(first["loss"] - ref["loss"]) / abs(ref["loss"]),
        grad_norm_rel_err=abs(first["grad_norm"] - ref["grad_norm"])
        / ref["grad_norm"])
    part = "(d)" if ref_layers is None else "(f)"
    log(f"--dist-only {part} {arch} {cfg.num_layers} layers {cfg.dtype} "
        f"trained on a {tuple(mesh.shape)} mesh: "
        f"{json.dumps(res, default=str)}")
    if not (res["loss_rel_err"] <= DIST_LOSS_TOL
            and res["grad_norm_rel_err"] <= DIST_NORM_TOL):
        raise AssertionError(f"sharded step off one card's: loss "
                             f"{first} vs {ref}")
    ckpt_dir = tempfile.mkdtemp(prefix="chip_smoke_dist_train_")
    try:
        res["fp32"] = dist_train_fp32(mesh, dev, arch, reduced, b, s,
                                      ckpt_dir, layers=fp32_layers)
    finally:
        shutil.rmtree(ckpt_dir, ignore_errors=True)
    return res


def dist_only(device: str) -> int:
    """--dist-only, one process per card under `torch.distributed.run`
    (RANK, LOCAL_RANK, WORLD_SIZE and the rendezvous from its
    environment): (a) `compression_check` over the 4-rank data axis of a
    (4, 1) mesh, (b) `dist_vlm_small` and `dist_flash_small` (fp32, bf16)
    on the (2, 2) mesh, (c) `dist_full` (qwen2-vl-72b's prefill and
    decode), (d) `dist_train` (zamba2-2.7b's train step), (e)
    `dist_moe_small` (fp32, bf16) and `dist_moe_full` (mixtral-8x7b's
    prefill and decode), (f) `dist_train` of olmoe-1b-7b; every weight
    gathered over "data" where its layer starts (FSDP x TP), the loss on
    each rank's vocab shard, the MoE dispatch partitioned. With device
    "cpu" (a rehearsal:
    gloo, the reduced configs, B=2 x S=64) the same on the CPU. Only rank
    0 prints; the kernels built are those (b)-(f) run: flash_attention
    and mamba_scan (with its backward)."""
    import torch
    import torch.distributed as dist
    from repro_torch.launch.mesh import make_host_mesh
    cpu = device == "cpu"
    if not cpu and not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    local = int(os.environ["LOCAL_RANK"])
    dev = torch.device("cpu") if cpu else torch.device("cuda", local)
    if not cpu:
        torch.cuda.set_device(dev)
    dist.init_process_group("gloo" if cpu else "nccl",
                            device_id=None if cpu else dev)
    t0 = time.perf_counter()
    try:
        world = dist.get_world_size()
        if world != 4:
            raise ValueError(f"--dist-only runs on 4 ranks, not {world}")
        if not cpu:
            log(f"device: {torch.cuda.get_device_name(dev)} x "
                f"{torch.cuda.device_count()}; nvidia-smi: {nvidia_smi()}; "
                f"torch {torch.__version__}, CUDA {torch.version.cuda}")
        kind = "cpu" if cpu else "cuda"
        out, seconds = {}, {}

        def done(part, t):
            seconds[part] = time.perf_counter() - t
            if not cpu:
                out[f"cards_after_{part}"] = cards()
                log(f"cards after ({part}): {out[f'cards_after_{part}']}")
                torch.cuda.empty_cache()
            return time.perf_counter()
        t = time.perf_counter()
        out["compression"] = compression_check(make_host_mesh(1, kind),
                                               dev, world)
        t = done("a", t)
        mesh = make_host_mesh(2, kind)
        kw = dict(b=2, s=64, reduced=True) if cpu else {}
        if not cpu:
            if dist.get_rank() == 0:      # the kernels of this path
                from repro_torch.kernels import build
                build.build_all(FLASH_BUILD + ("mamba_scan",))
            dist.barrier()
        out["small"], params = dist_vlm_small(mesh, dev, exact=False, **kw)
        del params
        out["flash_fp32"] = dist_flash_small(mesh, dev, "float32", 1e-4,
                                             **kw)
        out["flash_bf16"] = dist_flash_small(mesh, dev, "bfloat16",
                                             DIST_BF16_TOL, **kw)
        t = done("b", t)
        out["full"] = dist_full(mesh, dev, **kw)
        t = done("c", t)
        out["train"] = dist_train(mesh, dev, reduced=cpu)
        t = done("d", t)
        out["moe_fp32"] = dist_moe_small(mesh, dev, "float32", **kw)
        out["moe_bf16"] = dist_moe_small(mesh, dev, "bfloat16", **kw)
        out["moe_full"] = dist_moe_full(mesh, dev, **kw)
        t = done("e", t)
        out["moe_train"] = dist_train(
            mesh, dev, reduced=cpu, arch=MOE_TRAIN_ARCH,
            ref_layers=MOE_REF_CUT, fp32_layers=MOE_FP32_CUT)
        done("f", t)
        out["seconds"] = time.perf_counter() - t0
        out["seconds_by_part"] = seconds
        if dist.get_rank() == 0:
            out_dir = ROOT / "build"
            out_dir.mkdir(exist_ok=True)
            (out_dir / "chip_smoke_dist.json").write_text(
                json.dumps(out, indent=1, default=str))
        log(f"parts {seconds}; total {out['seconds']:.1f} s (--dist-only: "
            "no result line)")
    finally:
        dist.destroy_process_group()
    return 0


def main(argv=None) -> int:
    import argparse
    ap = argparse.ArgumentParser(description="Smoke test of the port on "
                                 "one NVIDIA card.")
    ap.add_argument("--access-scan-was", metavar="PATH",
                    help="an earlier access_scan.cu (C entry without the "
                    "scratch argument) to check and time beside the "
                    "kernel in phase 3")
    ap.add_argument("--migrate-was", metavar="PATH",
                    help="an earlier migrate.cu (C entry without the work "
                    "and scratch arguments) to check and time beside the "
                    "kernel in phases 3 and 10")
    only = ap.add_mutually_exclusive_group()
    only.add_argument("--engine-only", action="store_true",
                      help="run phases 1, 2 and 10 only, and print no "
                      "result line")
    only.add_argument("--hybrid-only", action="store_true",
                      help="run phases 1, 2, phase 3's flash_attention and "
                      "mamba_scan checks and phase 11 only, and print no "
                      "result line")
    only.add_argument("--train-only", action="store_true",
                      help="run phases 1, 2, phase 3's mamba_scan checks "
                      "and phase 12 only, and print no result line")
    only.add_argument("--crest-only", action="store_true",
                      help="run phases 1, 2 and 13 only, and print no "
                      "result line")
    only.add_argument("--families-only", action="store_true",
                      help="run phases 1, 2, phase 3's flash_attention "
                      "checks and phase 14 only, and print no result line")
    only.add_argument("--dist-only", action="store_true",
                      help="under `python3 -m torch.distributed.run "
                      "--standalone --nproc-per-node 4`: the distributed "
                      "layer on four cards (compressed all-reduce, a (2, "
                      "2) mesh, qwen2-vl-72b at all 80 layers, zamba2-2.7b "
                      "trained, mixtral-8x7b at all 32 layers, olmoe-1b-7b "
                      "trained); builds flash_attention and mamba_scan, no "
                      "result line")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                    help="--dist-only's device: cpu rehearses it with gloo "
                    "at the reduced config")
    args = ap.parse_args(argv)
    if args.dist_only:
        return dist_only(args.device)
    if args.device != "cuda":
        ap.error("--device cpu is for --dist-only")
    # phase 12 runs under deterministic algorithms, whose cuBLAS needs a
    # fixed workspace, set before CUDA starts (the size PyTorch picks by
    # default on Hopper)
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    try:
        from repro_torch.kernels import build
        from repro_torch.models.kvcache import KVCacheConfig
        from repro_torch.configs import get_config
    except ImportError as e:
        print(f"chip_smoke: run from a checkout of the repository ({e})",
              file=sys.stderr)
        return 2
    t_start = time.perf_counter()
    dev = torch.device("cuda")
    name, count = torch.cuda.get_device_name(0), torch.cuda.device_count()
    smi = nvidia_smi()
    log(f"device: {name} x{count}; nvidia-smi: {smi}; torch "
        f"{torch.__version__}, CUDA {torch.version.cuda}")

    t0 = time.perf_counter()
    logs = build.build_all()
    log(f"built {sorted(logs)} with {build.nvcc()} "
        f"({' '.join(build.NVCC_FLAGS[:2])}) in "
        f"{time.perf_counter() - t0:.1f} s")
    for kname, text in logs.items():
        for line in text.splitlines():
            if "registers" in line or "spill" in line or "Compiling" in line:
                log(f"  ptxas[{kname}] {line.strip()}")

    def kv_config(mc):
        return KVCacheConfig(
            num_layers=mc.num_layers, batch=SERVE["batch"],
            max_blocks=-(-SERVE["max_len"] // SERVE["block_tokens"]),
            block_tokens=SERVE["block_tokens"],
            num_kv_heads=mc.num_kv_heads, head_dim=mc.resolved_head_dim,
            dtype=mc.dtype)
    mc, om = get_config("chatglm3-6b"), get_config("olmoe-1b-7b")
    zb = get_config("zamba2-2.7b")
    enc_cfg, vlm_cfg = get_config(ENC_ARCH), get_config(VLM_ARCH)
    kv_cfg, okv = kv_config(mc), kv_config(om)
    pcfg, opcfg = kv_cfg.pool_config(), okv.pool_config()
    olmoe_pa = (okv.batch, om.num_heads, om.num_kv_heads,
                om.resolved_head_dim, okv.block_tokens, okv.max_blocks,
                opcfg.n_slots + 1)
    from repro_torch.core.collector import CollectorConfig

    def stamp(phase):
        log(f"[{time.perf_counter() - t_start:.1f} s] phase {phase}")

    migrate_was = _migrate_was(args.migrate_was) if args.migrate_was else None

    if args.engine_only:
        stamp(10)
        engine = engine_path(dev, check_engine_kernels(
            dev, engine_pool_config(), migrate_was))
        log(json.dumps({k: engine[k] for k in ("kernels", "graph", "trace")},
                       default=str))
        log(f"total {time.perf_counter() - t_start:.1f} s (phases 1, 2, 10 "
            "only: no result line)")
        return 0
    if args.hybrid_only:
        stamp(3)
        check_flash_attention(dev, mc, om, zb, enc_cfg, vlm_cfg)
        check_mamba_scan(dev, get_config("falcon-mamba-7b"), zb)
        stamp(11)
        hybrid = hybrid_path(dev)
        log(json.dumps(hybrid, default=str))
        log(f"total {time.perf_counter() - t_start:.1f} s (phases 1, 2, "
            "part of 3, 11 only: no result line)")
        return 0
    if args.train_only:
        stamp(3)
        check_mamba_scan(dev, get_config("falcon-mamba-7b"), zb)
        stamp(12)
        train = train_path(dev)
        log(json.dumps(train, default=str))
        log(f"total {time.perf_counter() - t_start:.1f} s (phases 1, 2, "
            "part of 3, 12 only: no result line)")
        return 0
    if args.families_only:
        stamp(3)
        flash = check_flash_attention(dev, mc, om, zb, enc_cfg, vlm_cfg)
        stamp(14)
        families = families_path(dev)
        log(json.dumps(dict(flash_attention=flash, **families), default=str))
        log(f"total {time.perf_counter() - t_start:.1f} s (phases 1, 2, "
            "part of 3, 14 only: no result line)")
        return 0
    if args.crest_only:
        stamp(13)
        crest_path(dev)
        log(f"total {time.perf_counter() - t_start:.1f} s (phases 1, 2, 13 "
            "only: no result line)")
        return 0
    stamp(3)
    kernels = {
        "paged_attention": check_paged_attention(dev, mc, kv_cfg, pcfg,
                                                 olmoe_pa),
        "access_scan": check_access_scan(dev, pcfg, opcfg,
                                         args.access_scan_was),
        "migrate": check_migrate(dev, pcfg, CollectorConfig().move_budget,
                                 opcfg, migrate_was),
        "flash_attention": check_flash_attention(dev, mc, om, zb, enc_cfg,
                                                 vlm_cfg),
        "mamba_scan": check_mamba_scan(dev, get_config("falcon-mamba-7b"),
                                       zb),
    }
    engine_kernels = check_engine_kernels(dev, engine_pool_config(),
                                          migrate_was)
    stamp("4-5")
    launches, serve_summary, steps = serve_full(dev)
    stamp(6)
    path = kernel_vs_plain(dev)
    path["prefill"] = prefill_flash_vs_blockwise(dev)
    path["falcon_mamba_prefill"] = mamba_kernel_vs_plain(dev)
    stamp(7)
    prefill_summary = prefill_full(dev)
    stamp(8)
    mamba = mamba_full(dev)
    stamp(9)
    olmoe = moe_path(dev)
    stamp(10)
    engine = engine_path(dev, engine_kernels)
    stamp(11)
    hybrid = hybrid_path(dev)
    stamp(12)
    train = train_path(dev)
    stamp(13)
    crest = crest_path(dev)
    stamp(14)
    families = families_path(dev)
    stamp(15)
    distributed = dist_path(dev)
    # each kernel's launches on the path that runs it, counted from 0
    main_launches = {k: launches[k] for k in HADES_KERNELS}
    main_launches["flash_attention"] = \
        prefill_summary["launches"]["flash_attention"]
    main_launches["mamba_scan"] = mamba["prefill"]["launches"]["mamba_scan"]
    main_launches["mamba_scan_bwd"] = \
        train["full"]["launches"]["mamba_scan_bwd"]
    # the backward kernel's row: its own source entry, in mamba_scan.cu
    kernels["mamba_scan_bwd"] = kernels["mamba_scan"].pop("bwd")

    rows = []
    for kname, k in kernels.items():
        row = {"name": kname, "route": "cuda",
               "source": "src/repro_torch/kernels/csrc/"
                         f"{KERNEL_SOURCE.get(kname, kname)}.cu",
               "replaces": TPU_KERNEL[kname],
               "launches": main_launches[kname],
               **{key: k[key] for key in (
                   "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
                   "library_ms", "device_ms", "plain_device_ms",
                   "library_device_ms")}}
        if kname in ("paged_attention", "flash_attention"):
            # at olmoe-1b-7b's shape (REP 1), which phase 9 runs
            row["olmoe"] = {key: k["olmoe"][key] for key in (
                "shape", "variant", "max_abs_err", "ms", "device_ms",
                "plain_ms", "bound_ms", "library_ms", "library_device_ms")}
            row["olmoe"]["launches"] = olmoe["launches"].get(
                kname, olmoe["flash_launches_per_prefill"])
        if kname == "mamba_scan_bwd":
            # at zamba2-2.7b's carry, which phase 12 (a) trains: launches
            # a train step; and the forward's launches there
            row["replaces_note"] = (
                "the gradient of mamba_scan_pallas, which has none: JAX "
                "does not differentiate it")
            z = k["zamba2"]
            row["zamba2"] = {key: z.get(key) for key in (
                "shape", "max_abs_err", "ms", "device_ms", "plain_ms",
                "plain_device_ms", "bound_ms", "bound_by", "library_ms",
                "library_device_ms")}
            row["zamba2"]["launches_per_train_step"] = \
                train["full"]["launches_per_step"]["mamba_scan_bwd"]
            row["zamba2"]["forward_launches_per_train_step"] = \
                train["full"]["launches_per_step"]["mamba_scan"]
        if kname in ("flash_attention", "mamba_scan"):
            # at zamba2-2.7b's shapes, which phase 11 runs: launches a
            # prefill (and a decode step)
            z = k["zamba2"]
            row["zamba2"] = {key: z.get(key) for key in (
                "shape", "variant", "max_abs_err", "max_abs_err_fp32", "ms",
                "device_ms", "plain_ms", "plain_device_ms", "bound_ms",
                "bound_by", "library_ms", "library_device_ms")}
            row["zamba2"]["launches"] = hybrid["prefill"]["launches"][kname]
            if kname == "mamba_scan":
                row["zamba2"]["launches_per_decode_step"] = \
                    hybrid["decode"]["launches_per_step"][kname]
        if kname == "flash_attention":
            # at the shapes phase 14 runs: seamless's encoder (non-causal)
            # and decoder, launches a prefill of its 24 + 24 layers, and
            # qwen2-vl's, launches a prefill of its first VLM_CUT layers
            keys = ("shape", "variant", "max_abs_err", "max_abs_err_fp32",
                    "ms", "device_ms", "plain_ms", "plain_device_ms",
                    "bound_ms", "bound_by", "library_ms",
                    "library_device_ms")
            enc, vlm = families["encdec"], families["vlm"]
            row["seamless"] = dict(
                encoder={key: k["seamless_encoder"].get(key)
                         for key in keys},
                decoder={key: k["seamless"].get(key) for key in keys},
                launches=enc["prefill"]["launches"][kname],
                launches_by_mask=enc["flash_modes"])
            row["qwen2_vl"] = {key: k["qwen2_vl"].get(key) for key in keys}
            row["qwen2_vl"].update(
                launches=vlm["prefill"]["launches"][kname],
                layers=vlm["layers"])
            # the variant the main path ran (phase 7 checks its name)
            row.update(source=FLASH_SOURCES[k["variant"]],
                       variant=k["variant"], cuda_cores_ms=k["cuda_cores_ms"])
        if kname == "paged_attention":
            # phase 4 checks that the serve path ran this variant only
            row.update(variant=k["variant"], granite={
                key: k["granite"][key] for key in (
                    "shape", "variant", "groups", "device_ms", "bound_ms",
                    "library_device_ms")})
        if kname == "migrate":
            # at olmoe-1b-7b's 128 KiB rows, which phase 9 moves
            row["olmoe"] = {key: k["olmoe"][key] for key in (
                "shape", "max_abs_err", "ms", "device_ms", "plain_ms",
                "bound_ms", "library_ms", "library_device_ms")}
            row["olmoe"]["launches"] = olmoe["launches"]["migrate"]
            # every case of phases 3 and 10: the three lists at the three
            # pools
            e = engine["kernels"]["migrate"]
            pools = dict(k["cases"], engine={
                "hazard": e, "disjoint": e["disjoint"], "swap": e["swap"]})
            row["cases"] = {f"{pool}/{case}": {key: c.get(key) for key in (
                "shape", "staged_share", "late_share", "device_ops", "ms",
                "device_ms",
                "plain_ms", "bound_ms", "library_ms", "library_device_ms",
                "was_device_ms")} for pool, cs in pools.items()
                for case, c in cs.items()}
            row.update(staged_share=k["staged_share"],
                       late_share=k["late_share"],
                       device_ops_per_call=k["device_ops"],
                       graph_nodes=k["graph_nodes"])
        if kname == "access_scan":
            row.update(device_ops_per_call=k["cases"][
                "kernel/serve/hist=False"]["device_ops"])
        if kname in ("access_scan", "migrate"):
            # at the object engine's shapes, which phase 10 runs
            e = engine["kernels"][kname]
            row["engine"] = {key: e[key] for key in (
                "shape", "max_abs_err", "ms", "device_ms", "plain_ms",
                "plain_device_ms", "bound_ms", "bound_by", "library_ms",
                "library_device_ms")}
            traced = engine["trace"]["kernels"][kname]
            row["engine"].update(
                launches=engine["graph"]["launches"][kname],
                graph_device_ms_per_launch=traced["device_ms_per_launch"],
                graph_bound_ms=traced["bound_ms"])
        rows.append(row)
    out_dir = ROOT / "build"
    out_dir.mkdir(exist_ok=True)
    (out_dir / "chip_smoke.json").write_text(json.dumps({
        "device": name, "nvidia_smi": smi, "kernels": rows,
        "kernel_shapes": {k: v["shape"] for k, v in kernels.items()},
        "library_calls": LIBRARY, "serve": serve_summary,
        "launches_per_step": {k: launches[k] / steps for k in HADES_KERNELS},
        "prefill": prefill_summary, "kernel_vs_plain": path,
        "falcon_mamba": mamba, "olmoe": olmoe, "engine": engine,
        "zamba2": hybrid, "train": train, "crest": crest,
        "encdec": families["encdec"], "vlm": families["vlm"],
        "families_seconds": families["seconds"], "dist": distributed,
        "seconds": time.perf_counter() - t_start}, indent=1))
    log(f"total {time.perf_counter() - t_start:.1f} s")
    print(smi)
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                             "count": count}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
