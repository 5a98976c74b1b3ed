"""Wrappers of the port's CUDA kernels.

Each wrapper takes the plain version in `ref.py` when its tensors lie on
the CPU, and only then. For CUDA tensors it checks device, dtype, shape
and contiguity, allocates outputs and scratch with `torch.empty`
(access_scan and migrate also keep a zeroed scratch per stream), launches
its kernel on the current stream (building it at first use, see
`build.py`), raises if the launch reports an error, and adds one to its
count in `launches`. Empty inputs return before the C entry point, which
therefore launches on every call. There is no fallback: a kernel that does
not build or launch raises.

`stamp` (the span recorder's device clock, `repro_torch/spans.py`) is the
one kernel that is not counted: it measures the main path, it is not part
of it, and it has no plain version (the recorder writes the host clock on
the CPU itself).

`mamba_scan` is differentiable: its backward is the kernel
`mamba_scan_bwd` (`_MambaScan`). `flash_attention` and `paged_attention`
have no gradient, as their TPU kernels have none: on every device they
raise when grad mode is on and an input requires grad.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Dict, Tuple

import torch

from repro_torch.kernels import build
from repro_torch.kernels import ref

# launches of each wrapper's kernel since the last reset (the main path's
# evidence); flash_attention's and paged_attention's count both of their
# variants
launches: Dict[str, int] = {name: 0 for name in (
    "paged_attention", "access_scan", "migrate", "flash_attention",
    "mamba_scan", "mamba_scan_bwd")}
# flash_attention's and paged_attention's launches by variant (see
# `_flash_variant`, `_paged_variant`)
TENSOR_CORES, CUDA_CORES = "tensor_cores", "cuda_cores"
flash_variants: Dict[str, int] = {TENSOR_CORES: 0, CUDA_CORES: 0}
paged_variants: Dict[str, int] = {TENSOR_CORES: 0, CUDA_CORES: 0}
# dtype codes of the C entry points
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


_COUNTERS = {"launches": launches, "flash_variants": flash_variants,
             "paged_variants": paged_variants}


def reset_launches() -> None:
    for counts in _COUNTERS.values():
        for name in counts:
            counts[name] = 0


def count_snapshot() -> Dict[str, Dict[str, int]]:
    """A copy of every count (`launches` and the variant counts)."""
    return {k: dict(v) for k, v in _COUNTERS.items()}


def counts_since(snap: Dict[str, Dict[str, int]]
                 ) -> Dict[str, Dict[str, int]]:
    """The counts added since `snap`, which every count is set back to (a
    graph capture records launches but makes none)."""
    delta = {}
    for k, counts in _COUNTERS.items():
        delta[k] = {n: c - snap[k][n] for n, c in counts.items()}
        counts.update(snap[k])
    return delta


def add_counts(delta: Dict[str, Dict[str, int]]) -> None:
    """Add the counts of one replay of a captured graph."""
    for k, counts in _COUNTERS.items():
        for n, c in delta[k].items():
            counts[n] += c


def _on_cpu(*tensors: torch.Tensor) -> bool:
    devs = {t.device for t in tensors}
    if len(devs) != 1:
        raise ValueError(
            f"tensors on several devices: {sorted(map(str, devs))}")
    dev = devs.pop()
    if dev.type == "cpu":
        return True
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    return False


def _check(cond: bool, msg: str) -> None:
    if not cond:
        raise ValueError(msg)


def _no_grad(name: str, *tensors: torch.Tensor) -> None:
    """Kernels without a gradient (nor had their TPU kernels one) refuse,
    on every device, an input that requires grad while grad mode is on."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in tensors):
        raise NotImplementedError(
            f"{name} has no gradient, as in the JAX package: train with "
            "attn_impl='blockwise' (or 'full')")


def _launch(name: str, *args, entry: str = "") -> None:
    """Calls the C entry point `entry` (by default `name`), which launches
    on every call (the wrappers never pass it empty inputs), and counts the
    launch as kernel `name`'s."""
    entry = entry or name
    lib = build.lib(entry)
    rc = getattr(lib, entry)(*args)
    if rc != 0:
        raise RuntimeError(f"{entry} kernel failed to launch: "
                           f"{lib.error_string(rc).decode()} (code {rc})")
    launches[name] += 1


def _stream() -> int:
    return torch.cuda.current_stream().cuda_stream


@functools.lru_cache(maxsize=None)
def _n_sms(device: torch.device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


# ---------------------------------------------------------------------------
# migrate
# ---------------------------------------------------------------------------
# migrate's zeroed scratch [4 counters | is_src[n_rows] | is_dst[n_rows]]
# bytes, one per (device, stream, n_rows); the kernel leaves it zero after
# every call
_mig_scratch: Dict[Tuple[int, int, int], torch.Tensor] = {}


def migrate(data: torch.Tensor, src: torch.Tensor, dst: torch.Tensor,
            ok: torch.Tensor) -> torch.Tensor:
    """In place: data[dst[i]] = data[src[i]] for every ok[i], every source
    read before any destination is written. data: [n_rows, W], whose last
    row is the pool's scratch row (masked moves leave it untouched);
    src/dst: [n] int32; ok: [n] bool. Returns data. On CUDA a call is one
    cooperative kernel launch and no other device operation: the staging
    rows and the move lists are `torch.empty`, and the marks and counters
    live in a scratch of the stream that the wrapper zeroes once, when the
    stream first calls it, and the kernel leaves zero (`ref.
    migrate_phased` models the kernel's three phases). A call captured in
    a CUDA graph is one kernel node if its stream has called it before."""
    if _on_cpu(data, src, dst, ok):
        return ref.migrate(data, src, dst, ok)
    n = src.shape[0]
    _check(data.dim() == 2 and data.is_contiguous(),
           "data: [n_rows, W] contiguous")
    _check(src.dtype == dst.dtype == torch.int32, "src/dst must be int32")
    _check(ok.dtype == torch.bool, "ok must be bool")
    _check(src.shape == dst.shape == ok.shape == (n,), "src/dst/ok: [n]")
    _check(src.is_contiguous() and dst.is_contiguous() and ok.is_contiguous(),
           "src/dst/ok must be contiguous")
    if n == 0 or data.numel() == 0:
        return data
    dev, n_rows = data.device, data.shape[0]
    staging = torch.empty((n, data.shape[1]), dtype=data.dtype, device=dev)
    work = torch.empty(4 * n, dtype=torch.int32, device=dev)
    stream = _stream()
    key = (dev.index, stream, n_rows)
    scratch = _mig_scratch.get(key)
    if scratch is None:
        scratch = _mig_scratch[key] = torch.zeros(16 + 2 * n_rows,
                                                  dtype=torch.uint8,
                                                  device=dev)
    _launch("migrate", data.data_ptr(), staging.data_ptr(), work.data_ptr(),
            scratch.data_ptr(), src.data_ptr(), dst.data_ptr(),
            ok.data_ptr(), n, n_rows, data.shape[1] * data.element_size(),
            _n_sms(dev), stream)
    return data


def graph_nodes(graph: "torch.cuda.CUDAGraph") -> Dict[str, int]:
    """What a graph captured with keep_graph=True holds: its nodes, its
    kernel nodes, and the kernel nodes that carry the cooperative launch
    attribute (read back from the graph, for tests and `chip_smoke.py`)."""
    lib = build.lib("migrate")
    lib.graph_nodes.argtypes = (ctypes.c_void_p, ctypes.c_void_p)
    lib.graph_nodes.restype = ctypes.c_int
    counts = (ctypes.c_int * 3)()
    rc = lib.graph_nodes(graph.raw_cuda_graph(), counts)
    if rc != 0:
        raise RuntimeError(f"graph_nodes failed: "
                           f"{lib.error_string(rc).decode()} (code {rc})")
    return dict(zip(("nodes", "kernels", "cooperative"), counts))


# ---------------------------------------------------------------------------
# access_scan
# ---------------------------------------------------------------------------
def _scan_layout(n: int, n_sbs: int) -> Tuple[Dict[str, int], int]:
    """Byte offsets of access_scan's outputs in the one buffer a call
    allocates, and its size: new_table (4n bytes), hist (4 * n_sbs),
    skipped (4), to_hot (n), to_cold (n), each at a 16-byte-aligned offset
    so that the kernel's vector stores stay aligned."""
    offsets, at = {}, 0
    for name, size in (("new_table", 4 * n), ("hist", 4 * n_sbs),
                       ("skipped", 4), ("to_hot", n), ("to_cold", n)):
        offsets[name] = at
        at += -(-size // 16) * 16
    return offsets, at


def _scan_outputs(n: int, n_sbs: int, dev: torch.device
                  ) -> Tuple[torch.Tensor, ...]:
    """(new_table [n] int32, to_hot [n] bool, to_cold [n] bool, hist
    [n_sbs] int32, skipped [] int32), uninitialised views of ONE buffer
    laid out by `_scan_layout` (every offset a multiple of 16 bytes)."""
    off, size = _scan_layout(n, n_sbs)
    buf = torch.empty(size // 4, dtype=torch.int32, device=dev)
    h, m = off["hist"] // 4, off["to_hot"] // 4
    masks = buf[m:].view(torch.bool)
    c = off["to_cold"] - off["to_hot"]
    return (buf[:n], masks[:n], masks[c:c + n], buf[h:h + n_sbs],
            buf[off["skipped"] // 4])


# access_scan's zeroed scratch [ticket and count as one u64 | 2 pad words |
# n_sbs bins] int32, one per (device, stream, n_sbs); the kernel leaves it
# zero after every call
_scan_scratch: Dict[Tuple[int, int, int], torch.Tensor] = {}


def access_scan(table: torch.Tensor, ciw_threshold: torch.Tensor, *,
                sb_slots: int, n_sbs: int, with_hist: bool = True
                ) -> Tuple[torch.Tensor, ...]:
    """table: [N] int32 words; ciw_threshold: [] float32 (read on the
    device). Returns (new_table [N] int32, to_hot [N] bool, to_cold [N]
    bool, hist [n_sbs] int32 — zeros when with_hist is False, skipped []
    int32). On CUDA the five are views of one buffer (`_scan_layout`), and
    a call is one kernel launch and no other device operation: it keeps
    its partial sums in a scratch of its stream that the wrapper zeroes
    once, when the stream first calls it, and the kernel leaves zero. A
    call captured in a CUDA graph is one kernel node if its stream has
    called it before the capture (else the capture also holds the
    scratch's one zeroing)."""
    if _on_cpu(table, ciw_threshold):
        return ref.access_scan(table, ciw_threshold, sb_slots=sb_slots,
                               n_sbs=n_sbs, with_hist=with_hist)
    _check(table.dim() == 1 and table.dtype == torch.int32
           and table.is_contiguous(), "table: [N] int32 contiguous")
    _check(ciw_threshold.dtype == torch.float32 and ciw_threshold.numel() == 1,
           "ciw_threshold: one float32")
    _check(sb_slots > 0 and n_sbs >= 0, "sb_slots > 0, n_sbs >= 0")
    n = table.shape[0]
    dev = table.device
    if n == 0:
        return (table.clone(), torch.zeros(0, dtype=torch.bool, device=dev),
                torch.zeros(0, dtype=torch.bool, device=dev),
                torch.zeros(n_sbs, dtype=torch.int32, device=dev),
                torch.zeros((), dtype=torch.int32, device=dev))
    new_table, to_hot, to_cold, hist, skipped = _scan_outputs(n, n_sbs, dev)
    stream = _stream()
    key = (dev.index, stream, n_sbs)
    scratch = _scan_scratch.get(key)
    if scratch is None:
        scratch = _scan_scratch[key] = torch.zeros(n_sbs + 4,
                                                   dtype=torch.int32,
                                                   device=dev)
    _launch("access_scan", table.data_ptr(), ciw_threshold.data_ptr(),
            new_table.data_ptr(), to_hot.data_ptr(), to_cold.data_ptr(),
            hist.data_ptr(), skipped.data_ptr(), scratch.data_ptr(), n,
            sb_slots, n_sbs, int(with_hist), _n_sms(dev), stream)
    return new_table, to_hot, to_cold, hist, skipped


# ---------------------------------------------------------------------------
# paged_attention
# ---------------------------------------------------------------------------
_SMEM_MAX = 232448          # what an H100 block can have (227 KB)
_PAGED_WARPS = 4            # warps of a tensor-core split block, at most


def _paged_variant(dtype: torch.dtype, rep: int, d: int,
                   ptrs: Tuple[int, ...], slot_stride: int) -> str:
    """The one rule that picks paged_attention's split kernel for CUDA
    tensors. TENSOR_CORES (mma.sync, pages by 16-byte cp.async) takes
    bfloat16 with D % 16 == 0 and D <= 256, at any REP (`_paged_groups`
    cuts the query group into blocks that fit), whose q/k/v base pointers
    (`ptrs`) are 16-byte aligned and whose slot stride is a multiple of 8
    elements. Everything else takes the CUDA-core kernel (CUDA_CORES):
    float32, other D, views cp.async cannot read. The rule is decided
    before the launch; nothing is tried and caught, and the kernel it
    picks launches or raises."""
    aligned = all(p % 16 == 0 for p in ptrs) and slot_stride % 8 == 0
    if dtype == torch.bfloat16 and d % 16 == 0 and d <= 256 and aligned:
        return TENSOR_CORES
    return CUDA_CORES


def _paged_groups(variant: str, rep: int, d: int) -> Tuple[int, int]:
    """(G, RG): a KV head's REP query heads go to G blocks of at most RG
    heads each, block g taking heads [g * RG, min(REP, (g + 1) * RG)).
    From static shapes only. The tensor-core kernel keeps a whole group
    in one block when a warp's fp32 accumulator holds it (ceil(REP / 16)
    m-tiles of 16 rows x D, at most 128 values a thread: REP <= 16, or
    REP <= 32 with D <= 128), else takes 16 heads a block (one m-tile, no
    pad rows at REP 48). The CUDA-core kernel runs one warp per head, at
    most 32 warps a block, in as few blocks of as even a size as it can."""
    if variant == TENSOR_CORES:
        rg = rep if rep <= 16 or (rep <= 32 and d <= 128) else 16
    else:
        rg = -(-rep // -(-rep // 32))
    return -(-rep // rg), rg


def _paged_splits(b: int, kv: int, mb: int, n_sms: int) -> Tuple[int, int]:
    """(n_splits, pages per split) from static shapes only: about 2 blocks
    per SM over the B * KV * n_splits grid (KV counts each KV head's
    blocks, `_paged_groups`' G of them), never more splits than pages.
    seq_lens never decides it (reading it would sync the host and break
    graph capture), so splits past a lane's length exit at once."""
    n = max(1, min(mb, -(-2 * n_sms // max(b * kv, 1))))
    pps = -(-mb // n)
    return -(-mb // pps), pps


def _paged_smem(variant: str, rg: int, d: int, bt: int, n_warps: int) -> int:
    """Shared memory of a split block of RG query heads (`split_smem_bytes`
    in csrc/paged_attention.cu computes the same)."""
    if variant == TENSOR_CORES:
        mt, ld, t = (2 if rg > 16 else 1), d + 8, -(-bt // 16) * 16
        return 2 * ld * (mt * 16 + 4 * n_warps * t) + 8 * n_warps * mt * 16
    return 4 * (rg * d + 2 * bt * d + rg * bt)


def paged_attention(q: torch.Tensor, k_pages: torch.Tensor,
                    v_pages: torch.Tensor, block_tables: torch.Tensor,
                    seq_lens: torch.Tensor
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """q: [B, H, D]; k_pages/v_pages: [n_slots, bt, KV, D], contiguous
    within a slot and sharing one slot stride (the pool's strided K and V
    views are taken as they are, never copied); block_tables: [B, MB]
    int32 slots (-1 unused); seq_lens: [B] int32. Returns (out [B, H, D]
    in q's dtype, touched [B, MB] bool). On CUDA: a split kernel over
    `_paged_splits` ranges of pages and `_paged_groups` groups of query
    heads (`_paged_variant` picks it; `paged_variants` counts each)
    writes fp32 partials, and a combine
    kernel merges them and writes the access bits; one launch counted.
    No host sync, and a launch shape that depends on shapes only, so the
    call can be captured in a CUDA graph."""
    _no_grad("paged_attention", q, k_pages, v_pages)
    if _on_cpu(q, k_pages, v_pages, block_tables, seq_lens):
        return ref.paged_attention(q, k_pages, v_pages, block_tables,
                                   seq_lens)
    _check(q.dim() == 3 and q.is_contiguous(), "q: [B, H, D] contiguous")
    b, h, d = q.shape
    _check(k_pages.dim() == 4 and k_pages.shape == v_pages.shape,
           "k_pages/v_pages: [n_slots, bt, KV, D]")
    n_slots, bt, kv, d2 = k_pages.shape
    _check(d2 == d and h % kv == 0, "head dims disagree or H % KV != 0")
    _check(q.dtype in _DTYPES and k_pages.dtype == v_pages.dtype == q.dtype,
           "q/k/v must share one dtype, float32 or bfloat16")
    inner = (kv * d, d, 1)
    _check(k_pages.stride()[1:] == inner and v_pages.stride()[1:] == inner
           and k_pages.stride(0) == v_pages.stride(0),
           "k/v pages must be contiguous within a slot, one slot stride")
    mb = block_tables.shape[1] if block_tables.dim() == 2 else -1
    _check(block_tables.shape == (b, mb) and block_tables.dtype == torch.int32
           and block_tables.is_contiguous(), "block_tables: [B, MB] int32")
    _check(seq_lens.shape == (b,) and seq_lens.dtype == torch.int32
           and seq_lens.is_contiguous(), "seq_lens: [B] int32")
    rep = h // kv
    _check(d <= 256, "the kernel takes D <= 256")
    slot_stride = k_pages.stride(0)
    variant = _paged_variant(q.dtype, rep, d, (q.data_ptr(),
                             k_pages.data_ptr(), v_pages.data_ptr()),
                             slot_stride)
    groups, rg = _paged_groups(variant, rep, d)
    n_splits, pps = _paged_splits(b, kv * groups, max(mb, 1),
                                  _n_sms(q.device))
    n_warps = 1
    if variant == TENSOR_CORES:
        n_warps = min(_PAGED_WARPS, pps)
        while n_warps > 1 and _paged_smem(variant, rg, d, bt,
                                          n_warps) > _SMEM_MAX:
            n_warps -= 1
    smem = _paged_smem(variant, rg, d, bt, n_warps)
    _check(smem <= _SMEM_MAX, f"tiles need {smem} B of shared memory")
    out = torch.empty_like(q)
    touched = torch.empty((b, mb), dtype=torch.bool, device=q.device)
    if b == 0 or kv == 0:
        return out, touched
    part_m = torch.empty((b, kv, n_splits, rep), dtype=torch.float32,
                         device=q.device)
    part_l = torch.empty_like(part_m)
    part_acc = torch.empty((b, kv, n_splits, rep, d), dtype=torch.float32,
                           device=q.device)
    _launch("paged_attention", q.data_ptr(), k_pages.data_ptr(),
            v_pages.data_ptr(), block_tables.data_ptr(), seq_lens.data_ptr(),
            out.data_ptr(), touched.data_ptr(), part_m.data_ptr(),
            part_l.data_ptr(), part_acc.data_ptr(),
            b, kv, rep, rg, d, bt, mb, n_slots, slot_stride, d ** -0.5,
            _DTYPES[q.dtype], int(variant == TENSOR_CORES), n_splits, pps,
            n_warps, _stream())
    paged_variants[variant] += 1
    return out, touched


# ---------------------------------------------------------------------------
# flash_attention
# ---------------------------------------------------------------------------
def _flash_variant(dtype: torch.dtype, d: int, ptrs: Tuple[int, ...],
                   strides: Tuple[int, ...]) -> str:
    """The one rule that picks flash_attention's kernel for CUDA tensors.
    `flash_attention_wgmma.cu` (TENSOR_CORES: wgmma, K/V by TMA) takes
    bfloat16 with D <= 128 and D % 8 == 0 whose base pointers (`ptrs`) are
    16-byte aligned and whose element strides other than D's (`strides`)
    are positive multiples of 8, which is what a TMA tensor map can
    describe. Everything else takes `flash_attention.cu` (CUDA_CORES): float32,
    D in (128, 256], and views TMA cannot describe. The rule is decided
    before the launch; nothing is tried and caught, and the kernel it picks
    launches or raises."""
    tma_ok = (all(p % 16 == 0 for p in ptrs)
              and all(s > 0 and s % 8 == 0 for s in strides))
    if dtype == torch.bfloat16 and d <= 128 and d % 8 == 0 and tma_ok:
        return TENSOR_CORES
    return CUDA_CORES


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: int = 0) -> torch.Tensor:
    """q: [B, S, H, D]; k/v: [B, S, KV, D] -> [B, S, H, D] in q's dtype.
    Each may be a strided view with unit stride along D (the kernels read
    them where they lie: no GQA repeat, transpose or padding). The TPU
    kernel's shape contract holds on every device: S <= 128 or S a
    multiple of 128 (its query block is min(128, S) and must divide S).
    `_flash_variant` picks the kernel; `launches["flash_attention"]` counts
    both, `flash_variants` each."""
    _check(q.dim() == 4 and k.dim() == 4 and k.shape == v.shape,
           "q: [B, S, H, D]; k/v: [B, S, KV, D]")
    b, s, h, d = q.shape
    kv = k.shape[2]
    _check(k.shape[:2] == (b, s) and k.shape[3] == d,
           "q and k/v disagree in batch, length or head dim")
    _check(kv > 0 and h % kv == 0, "H must be a multiple of KV")
    _check(s <= 128 or s % 128 == 0,
           f"S={s}: the flash kernel takes S <= 128 or a multiple of 128")
    _no_grad("flash_attention", q, k, v)
    if _on_cpu(q, k, v):
        return ref.flash_attention(q, k, v, causal=causal, window=window)
    _check(q.dtype in _DTYPES and k.dtype == v.dtype == q.dtype,
           "q/k/v must share one dtype, float32 or bfloat16")
    _check(q.stride(3) == k.stride(3) == v.stride(3) == 1,
           "q/k/v need unit stride along D")
    _check(d <= 256, "the kernel takes D <= 256")
    out = torch.empty((b, s, h, d), dtype=q.dtype, device=q.device)
    if out.numel() == 0:
        return out
    ptrs = (q.data_ptr(), k.data_ptr(), v.data_ptr())
    st = (*q.stride()[:3], *k.stride()[:3], *v.stride()[:3])
    strides = (ctypes.c_longlong * 9)(*st)
    args = (*ptrs, out.data_ptr(), b, s, h, kv, d, strides, d ** -0.5,
            int(causal), window)
    variant = _flash_variant(q.dtype, d, ptrs, st)
    if variant == TENSOR_CORES:
        _launch("flash_attention", *args, _stream(),
                entry="flash_attention_wgmma")
    else:
        _launch("flash_attention", *args, _DTYPES[q.dtype], _stream())
    flash_variants[variant] += 1
    return out


# ---------------------------------------------------------------------------
# mamba_scan
# ---------------------------------------------------------------------------
def _mamba_scan_fwd(a: torch.Tensor, b: torch.Tensor, h0: torch.Tensor
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    if _on_cpu(a, b, h0):
        return ref.mamba_scan(a, b, h0)
    _check(a.dim() == 4 and a.shape == b.shape, "a/b: [B, S, C, N]")
    bsz, s, c, n = a.shape
    _check(h0.shape == (bsz, c, n), "h0: [B, C, N]")
    _check(a.dtype in _DTYPES and b.dtype == a.dtype,
           "a/b must share one dtype, float32 or bfloat16")
    _check(h0.dtype == torch.float32, "h0 must be float32")
    _check(a.is_contiguous() and b.is_contiguous() and h0.is_contiguous(),
           "a/b/h0 must be contiguous")
    h_all = torch.empty(a.shape, dtype=torch.float32, device=a.device)
    h_last = torch.empty(h0.shape, dtype=torch.float32, device=a.device)
    if h_all.numel() == 0:
        return h_all, h_last.copy_(h0)
    _launch("mamba_scan", a.data_ptr(), b.data_ptr(), h0.data_ptr(),
            h_all.data_ptr(), h_last.data_ptr(), bsz, s, c * n,
            _DTYPES[a.dtype], _stream())
    return h_all, h_last


def mamba_scan_bwd(a: torch.Tensor, h0: torch.Tensor, h_all: torch.Tensor,
                   dh_all: torch.Tensor, dh_last: torch.Tensor
                   ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The gradient of `mamba_scan` (`ref.mamba_scan_bwd` says what it
    computes): a [B, S, C, N] float32 or bfloat16 and h0 [B, C, N] float32,
    contiguous, as the forward took them; h_all its output; dh_all, dh_last
    the gradients of its outputs (float32, made contiguous here). Returns
    (da, db) in a's dtype and dh0 float32, bit for bit the plain
    version's. One launch of `mamba_scan_bwd_kernel`, which reads time
    backwards in place."""
    if _on_cpu(a, h0, h_all, dh_all, dh_last):
        return ref.mamba_scan_bwd(a, h0, h_all, dh_all, dh_last)
    _check(a.dim() == 4 and h_all.shape == dh_all.shape == a.shape,
           "a/h_all/dh_all: [B, S, C, N]")
    bsz, s, c, n = a.shape
    _check(h0.shape == dh_last.shape == (bsz, c, n), "h0/dh_last: [B, C, N]")
    _check(a.dtype in _DTYPES, "a must be float32 or bfloat16")
    _check(h0.dtype == h_all.dtype == dh_all.dtype == dh_last.dtype
           == torch.float32, "h0, h_all and the gradients must be float32")
    _check(a.is_contiguous() and h0.is_contiguous()
           and h_all.is_contiguous(), "a/h0/h_all must be contiguous")
    dh_all, dh_last = dh_all.contiguous(), dh_last.contiguous()
    da = torch.empty(a.shape, dtype=a.dtype, device=a.device)
    db = torch.empty(a.shape, dtype=a.dtype, device=a.device)
    dh0 = torch.empty(h0.shape, dtype=torch.float32, device=a.device)
    if da.numel() == 0:
        return da, db, dh0.copy_(dh_last)
    _launch("mamba_scan_bwd", a.data_ptr(), h0.data_ptr(), h_all.data_ptr(),
            dh_all.data_ptr(), dh_last.data_ptr(), da.data_ptr(),
            db.data_ptr(), dh0.data_ptr(), bsz, s, c * n, _DTYPES[a.dtype],
            _stream())
    return da, db, dh0


class _MambaScan(torch.autograd.Function):
    """mamba_scan with its gradient: the backward runs `mamba_scan_bwd`
    (the kernel on CUDA, the plain loop on the CPU) from the saved a, h0
    and h_all."""

    @staticmethod
    def forward(ctx, a, b, h0):
        h_all, h_last = _mamba_scan_fwd(a, b, h0)
        ctx.save_for_backward(a, h0, h_all)
        return h_all, h_last

    @staticmethod
    def backward(ctx, dh_all, dh_last):
        a, h0, h_all = ctx.saved_tensors
        return mamba_scan_bwd(a, h0.float(), h_all, dh_all, dh_last)


def mamba_scan(a: torch.Tensor, b: torch.Tensor, h0: torch.Tensor
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """h_t = a_t * h_{t-1} + b_t per lane. a, b: [B, S, C, N] contiguous,
    one dtype, float32 or bfloat16; h0: [B, C, N] contiguous float32.
    Returns (h_all [B, S, C, N] fp32, h_last [B, C, N] fp32), bit for bit
    the plain version's. Differentiable in a, b and h0 (`_MambaScan`):
    the gradient is bit for bit autograd's through the plain version."""
    return _MambaScan.apply(a, b, h0)


# ---------------------------------------------------------------------------
# stamp (the span recorder's device clock; no TPU counterpart)
# ---------------------------------------------------------------------------
def stamp(area: torch.Tensor, k: int) -> None:
    """Write the device clock (%globaltimer, ns) into slot `k` of `area`, a
    contiguous float64 CUDA tensor: slot 0 takes the reading's raw 64 bits,
    slot k > 0 the reading minus slot 0's as a float64 (`csrc/stamp.cu`).
    One launch of one thread on the current stream; not counted in
    `launches`."""
    _check(area.device.type == "cuda", "stamp: the area must lie on CUDA")
    _check(area.dtype == torch.float64 and area.is_contiguous(),
           "stamp: the area must be contiguous float64")
    _check(0 <= k < area.numel(), f"stamp: slot {k} outside the area")
    lib = build.lib("stamp")
    rc = lib.stamp(area.data_ptr(), k, _stream())
    if rc != 0:
        raise RuntimeError(f"stamp kernel failed to launch: "
                           f"{lib.error_string(rc).decode()} (code {rc})")
