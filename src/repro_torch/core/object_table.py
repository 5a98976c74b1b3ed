"""Object table — packed per-object metadata words (port of
`repro/core/object_table.py`).

Each managed object has one packed 32-bit word:

    [ ciw:5 | atc:4 | access:1 | heap:2 | slot:20 ]   (MSB..LSB)

  slot   — physical slot index in the pool (up to 2^20 slots)
  heap   — NEW(0) / HOT(1) / COLD(2) / FREE(3)
  access — access bit, set on dereference
  atc    — Active Thread Count analog: saturating count of accesses while
           a migration window is armed; an object with atc > 0 never moves
  ciw    — Consecutive Inactive Windows, saturating at 31

The words are carried as `torch.int32` with the same bits as the JAX
package's uint32 (compare through numpy `.view(np.int32)`): PyTorch on
the CPU has no shift, add, invert or minimum for uint32. CIW sits in bits
27–31, so the sign bit is set whenever CIW >= 16 and `>>` is arithmetic:
every field read masks AFTER its shift.
"""
from __future__ import annotations

import torch

SLOT_BITS = 20
HEAP_BITS = 2
ACCESS_BITS = 1
ATC_BITS = 4
CIW_BITS = 5
assert SLOT_BITS + HEAP_BITS + ACCESS_BITS + ATC_BITS + CIW_BITS == 32

SLOT_SHIFT = 0
HEAP_SHIFT = SLOT_BITS
ACCESS_SHIFT = HEAP_SHIFT + HEAP_BITS
ATC_SHIFT = ACCESS_SHIFT + ACCESS_BITS
CIW_SHIFT = ATC_SHIFT + ATC_BITS

SLOT_MASK = (1 << SLOT_BITS) - 1
HEAP_MASK = (1 << HEAP_BITS) - 1
ACCESS_MASK = 1
ATC_MASK = (1 << ATC_BITS) - 1
CIW_MASK = (1 << CIW_BITS) - 1

MAX_SLOTS = 1 << SLOT_BITS          # slots a word can address
CIW_SAT = (1 << CIW_BITS) - 1
ATC_SAT = (1 << ATC_BITS) - 1

# heap ids
NEW, HOT, COLD, FREE = 0, 1, 2, 3


def _i32(bits: int) -> int:
    """A 32-bit pattern as the signed Python int an int32 tensor holds."""
    bits &= 0xFFFFFFFF
    return bits - (1 << 32) if bits >= 1 << 31 else bits


def _field(v, mask: int, shift: int):
    """(v & mask) << shift: a tensor for a tensor, an int32-valued Python
    int for an int (a Python scalar never becomes a host-to-device copy)."""
    if isinstance(v, torch.Tensor):
        return (v.to(torch.int32) & mask) << shift
    return _i32((int(v) & mask) << shift)


def pack(slot, heap, access=0, atc=0, ciw=0) -> torch.Tensor:
    """Pack fields -> int32 word(s). Each field may be a tensor or an int
    (at least one a tensor); the word lies on the tensor fields' device."""
    return (_field(slot, SLOT_MASK, SLOT_SHIFT)
            | _field(heap, HEAP_MASK, HEAP_SHIFT)
            | _field(access, ACCESS_MASK, ACCESS_SHIFT)
            | _field(atc, ATC_MASK, ATC_SHIFT)
            | _field(ciw, CIW_MASK, CIW_SHIFT))


def slot_of(w): return (w >> SLOT_SHIFT) & SLOT_MASK
def heap_of(w): return (w >> HEAP_SHIFT) & HEAP_MASK
def access_of(w): return (w >> ACCESS_SHIFT) & ACCESS_MASK
def atc_of(w): return (w >> ATC_SHIFT) & ATC_MASK
def ciw_of(w): return (w >> CIW_SHIFT) & CIW_MASK


def _with(w, v, mask: int, shift: int):
    return (w & _i32(~(mask << shift))) | _field(v, mask, shift)


def with_slot(w, slot): return _with(w, slot, SLOT_MASK, SLOT_SHIFT)
def with_heap(w, heap): return _with(w, heap, HEAP_MASK, HEAP_SHIFT)
def with_access(w, a): return _with(w, a, ACCESS_MASK, ACCESS_SHIFT)
def with_atc(w, atc): return _with(w, atc, ATC_MASK, ATC_SHIFT)
def with_ciw(w, ciw): return _with(w, ciw, CIW_MASK, CIW_SHIFT)


FREE_WORD = FREE << HEAP_SHIFT      # heap=FREE, slot=0: 'no object'


def free_word(device=None) -> torch.Tensor:
    """A 0-d word denoting 'no object' (heap=FREE, slot=0)."""
    return torch.tensor(FREE_WORD, dtype=torch.int32, device=device)


def make_table(num_objects: int, device=None) -> torch.Tensor:
    return torch.full((num_objects,), FREE_WORD, dtype=torch.int32,
                      device=device)


def is_live(w) -> torch.Tensor:
    return heap_of(w) != FREE


def _sink_index(idx: torch.Tensor, n: int) -> torch.Tensor:
    return torch.where((idx >= 0) & (idx < n), idx, n).long()


def set_drop(buf: torch.Tensor, idx: torch.Tensor, vals) -> torch.Tensor:
    """`buf.at[idx].set(vals, mode="drop")`: a new tensor with
    buf[idx[i]] = vals[i] along axis 0 where 0 <= idx[i] < len(buf); the
    other entries are routed to a sink row one past the end and dropped.
    `vals` is a tensor or a Python scalar."""
    n = buf.shape[0]
    ext = torch.cat([buf, buf.new_zeros((1,) + tuple(buf.shape[1:]))])
    if not isinstance(vals, torch.Tensor):
        # a fill, not a host-to-device copy of the scalar
        vals = torch.full(idx.shape, vals, dtype=buf.dtype, device=buf.device)
    ext[_sink_index(idx, n)] = vals.to(buf.dtype)
    return ext[:n]


def add_drop(buf: torch.Tensor, idx: torch.Tensor, val: int) -> torch.Tensor:
    """`buf.at[idx].add(val, mode="drop")` along axis 0 (see set_drop)."""
    n = buf.shape[0]
    ext = torch.cat([buf, buf.new_zeros((1,) + tuple(buf.shape[1:]))])
    ext.index_put_((_sink_index(idx, n),),
                   torch.full(idx.shape, val, dtype=buf.dtype,
                              device=buf.device), accumulate=True)
    return ext[:n]


def hit_mask(n: int, obj_ids: torch.Tensor) -> torch.Tensor:
    """[n] bool, True at every valid id of `obj_ids` (ids < 0 or >= n are
    dropped, never redirected to id 0)."""
    return set_drop(torch.zeros(n, dtype=torch.bool, device=obj_ids.device),
                    obj_ids, True)


def record_access(table: torch.Tensor, obj_ids: torch.Tensor,
                  armed=False) -> torch.Tensor:
    """Set access bits for obj_ids; when the migration window is `armed`
    (bool or 0-d bool tensor) also bump the saturating ATC. Invalid ids
    (< 0) are dropped: a batch holding both a padding entry and a real
    access to object 0 must not write conflicting words to index 0.
    Duplicate ids bump the ATC once per batch."""
    hit = hit_mask(table.shape[0], obj_ids)
    word = table | (ACCESS_MASK << ACCESS_SHIFT)
    bump = hit & (armed.bool() if isinstance(armed, torch.Tensor)
                  else bool(armed))
    word = torch.where(bump, with_atc(word, torch.clamp(
        atc_of(word) + 1, max=ATC_SAT)), word)
    return torch.where(hit, word, table)


def clear_access_and_atc(table: torch.Tensor) -> torch.Tensor:
    return table & _i32(~((ACCESS_MASK << ACCESS_SHIFT)
                          | (ATC_MASK << ATC_SHIFT)))
