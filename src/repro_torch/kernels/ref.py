"""Plain PyTorch versions of the port's kernels.

Each function has the signature of its wrapper in `ops.py`, so the two are
interchangeable: the wrappers take these for CPU tensors, the CPU tests
hold them against the JAX package, and `chip_smoke.py` holds each CUDA
kernel against its plain version on the card.
"""
from __future__ import annotations

from typing import Tuple

import torch

from repro_torch.core import object_table as ot
from repro_torch.models import attention as attn_lib

_I32 = torch.int32


def migrate(data: torch.Tensor, src: torch.Tensor, dst: torch.Tensor,
            ok: torch.Tensor) -> torch.Tensor:
    """In place: data[dst[i]] = data[src[i]] for every ok[i], every source
    read before any write. data is [n_rows, W] whose LAST row is the
    pool's all-zero scratch row: masked moves copy it onto itself, so it
    stays zero. Sources clamp into range (XLA gather semantics);
    destinations out of range are dropped. Returns data."""
    scratch = data.shape[0] - 1
    s = torch.where(ok, src.clamp(0, scratch), scratch).long()
    in_range = ok & (dst >= 0) & (dst < data.shape[0])
    d = torch.where(in_range, dst, scratch).long()
    rows = data[s]
    data[d] = torch.where(in_range[:, None], rows, data[scratch])
    return data


def migrate_phased(data: torch.Tensor, src: torch.Tensor, dst: torch.Tensor,
                   ok: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """`migrate` as the CUDA kernel orders it, in three phases. (1) The live
    moves (ok, destination in range; source clamped) mark their sources
    and destinations. (2) A move whose destination is no live source is
    early: it copies straight across. A move whose destination is a live
    source and whose source is a live destination is staged: its source
    row is read into staging. (3) The staged rows are written to their
    destinations, and the remaining (late) moves copy straight across.
    Within each phase the writes land before the reads they could spoil,
    the order in which a wrong split would show. In place; returns (data,
    staged [n] bool). For the tests and `chip_smoke.py` only (the kernel's
    model; boolean indexing syncs)."""
    n_rows = data.shape[0]
    live = ok & (dst >= 0) & (dst < n_rows)
    s = src.clamp(0, n_rows - 1).long()
    d = torch.where(live, dst, n_rows).long()      # n_rows: no row
    is_src = torch.zeros(n_rows + 1, dtype=torch.bool, device=data.device)
    is_dst = torch.zeros_like(is_src)
    is_src[torch.where(live, s, n_rows)] = True
    is_dst[d] = True
    is_src[n_rows] = is_dst[n_rows] = False
    read, written = is_src[d], is_dst[s]
    early, staged = live & ~read, live & read & written
    late = live & read & ~written
    data[d[early]] = data[s[early]]                         # phase 2
    staging = data[s[staged]]
    data[d[staged]] = staging                               # phase 3
    data[d[late]] = data[s[late]]
    return data, staged


def access_scan(table: torch.Tensor, ciw_threshold: torch.Tensor, *,
                sb_slots: int, n_sbs: int, with_hist: bool = True
                ) -> Tuple[torch.Tensor, ...]:
    """One pass over the packed table words [N] int32. Returns (new_table
    with CIW updated, to_hot [N] bool, to_cold [N] bool, hist [n_sbs] int32
    (accessed objects per superblock of their current slot; zeros when
    with_hist is False), skipped [] int32 (live objects the ATC rule
    vetoed))."""
    live = ot.is_live(table)
    acc = (ot.access_of(table) == 1) & live
    atc = ot.atc_of(table)
    heap = ot.heap_of(table)
    ciw = torch.where(acc, 0, torch.clamp(ot.ciw_of(table) + 1,
                                          max=ot.CIW_SAT))
    ciw = torch.where(live, ciw, 0)
    ct = torch.floor(ciw_threshold).to(_I32)
    movable = live & (atc == 0)
    to_hot = acc & ((heap == ot.NEW) | (heap == ot.COLD)) & movable
    to_cold = (~acc) & (ciw > ct) & ((heap == ot.NEW) | (heap == ot.HOT)) \
        & movable
    new_table = ot.with_ciw(table, ciw)
    hist = torch.zeros(n_sbs, dtype=_I32, device=table.device)
    if with_hist:
        sb = (ot.slot_of(table) // sb_slots).long()
        hist = ot.add_drop(hist, torch.where(acc, sb, n_sbs), 1)
    skipped = (live & (atc > 0) & (acc | ((ciw > ct) & (heap != ot.COLD)))
               ).sum(dtype=_I32)
    return new_table, to_hot, to_cold, hist, skipped


def paged_attention(q: torch.Tensor, k_pages: torch.Tensor,
                    v_pages: torch.Tensor, block_tables: torch.Tensor,
                    seq_lens: torch.Tensor
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One query token per sequence over a block-paged KV cache.

    q: [B, H, D]; k_pages/v_pages: [n_slots, bt, KV, D] (the pool's data,
    possibly strided views); block_tables: [B, MB] physical slot per
    logical block (-1 = unused); seq_lens: [B]. Positions at or past
    seq_len, and blocks with table -1, are masked. A lane with no valid
    position returns zeros (the TPU kernel returns a mean over slot 0
    there, which `kvcache.attend` masks out either way). Returns
    (out [B, H, D] in q's dtype, touched [B, MB] bool — the access bits:
    block j was read iff j*bt < seq_len and its table entry is >= 0)."""
    b, h, d = q.shape
    n_slots, bt, kv, _ = k_pages.shape
    mb = block_tables.shape[1]
    safe = block_tables.clamp(0, n_slots - 1).long()
    # fp32 arithmetic, as the kernels (TPU and CUDA) do
    k = k_pages[safe].reshape(b, mb * bt, kv, d).float()
    v = v_pages[safe].reshape(b, mb * bt, kv, d).float()
    pos = torch.arange(mb * bt, device=q.device)[None]
    valid = (pos < seq_lens[:, None]) & \
        torch.repeat_interleave(block_tables >= 0, bt, dim=1)
    out, m, l = attn_lib.decode_attention_partial(q[:, None].float(), k, v,
                                                  valid)
    out = out / torch.clamp(l, min=1e-30).movedim(1, -1)[..., None]
    out = torch.where(valid.any(1)[:, None, None, None], out, 0)
    touched = (torch.arange(mb, device=q.device)[None] * bt
               < seq_lens[:, None]) & (block_tables >= 0)
    return out[:, 0].to(q.dtype), touched


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: int = 0) -> torch.Tensor:
    """Self-attention over full sequences, in fp32 as the kernels (TPU and
    CUDA) compute it. q: [B, S, H, D]; k/v: [B, S, KV, D]; query head h
    reads KV head h // (H / KV). q is scaled by D**-0.5 before the product;
    softmax and P.V run in fp32; the output [B, S, H, D] is cast to q's
    dtype. The mask is built from the absolute positions i, j in [0, S)
    (causal: j <= i; window > 0: j > i - window), never from explicit
    positions, like the TPU kernel's iota mask."""
    b, s, h, d = q.shape
    kv = k.shape[2]
    qg = q.float().reshape(b, s, kv, h // kv, d) * d ** -0.5
    scores = torch.einsum("bskrd,btkd->bkrst", qg, k.float())
    pos = torch.arange(s, device=q.device)
    bias = attn_lib._mask_bias(pos[None], pos[None], causal, window)[0]
    probs = torch.softmax(scores + bias, dim=-1)
    out = torch.einsum("bkrst,btkd->bskrd", probs, v.float())
    return out.reshape(b, s, h, d).to(q.dtype)


def mamba_scan(a: torch.Tensor, b: torch.Tensor, h0: torch.Tensor
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The selective-SSM recurrence h_t = a_t * h_{t-1} + b_t, per lane
    (b, c, n), in fp32. a, b: [B, S, C, N] fp32 or bf16; h0: [B, C, N].
    Each step is a separate product and sum (two roundings, no fused
    multiply-add), as the CUDA kernel computes it. Returns (h_all [B, S, C,
    N] fp32, h_last [B, C, N] fp32)."""
    a, b = a.float(), b.float()
    h = h0.float()
    h_all = torch.empty(a.shape, dtype=torch.float32, device=a.device)
    for t in range(a.shape[1]):
        h = a[:, t] * h + b[:, t]
        h_all[:, t] = h
    return h_all, h.clone()


def mamba_scan_bwd(a: torch.Tensor, h0: torch.Tensor, h_all: torch.Tensor,
                   dh_all: torch.Tensor, dh_last: torch.Tensor
                   ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The gradient of `mamba_scan` (b shares a's dtype): given its inputs
    a, h0, its output h_all and the gradients dh_all [B, S, C, N], dh_last
    [B, C, N] of its two outputs, one reverse pass per lane with the
    carry c (c = dh_last at t = S - 1, then a_{t+1} * g_{t+1}):
    g_t = dh_t + c, da_t = g_t * h_{t-1} (h_{-1} = h0), db_t = g_t, and
    dh0 = a_0 * g_0; each a rounded product or sum, never fused. That is
    what autograd computes through the loop above, bit for bit. Returns
    (da, db) in a's dtype and dh0 fp32."""
    a32 = a.float()
    c = dh_last.float()
    da = torch.empty(a.shape, dtype=torch.float32, device=a.device)
    db = torch.empty(a.shape, dtype=torch.float32, device=a.device)
    for t in reversed(range(a.shape[1])):
        g = dh_all[:, t] + c
        da[:, t] = g * (h_all[:, t - 1] if t else h0)
        db[:, t] = g
        c = g * a32[:, t]
    return da.to(a.dtype), db.to(a.dtype), c.clone()
