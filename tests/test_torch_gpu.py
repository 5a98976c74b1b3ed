"""Every CUDA kernel of the port against its plain version on the card,
at the CPU tests' shapes and at the shapes of the paths that run it. Marked `gpu`: each
test skips without a CUDA device. This file imports no JAX, so it runs on
a machine that has only PyTorch:

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_gpu.py
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")  # the port's tests need PyTorch

from repro_torch.data.structures import STRUCTURES
from repro_torch.kernels import ops as tops
from repro_torch.kernels import ref as tref

# paged_attention: tests/test_kernels.py's shapes (b, h, kv, d, bt, mb) and
# an MQA group of REP 48 (granite's H/KV), which runs as several blocks
PA_SHAPES = [(2, 8, 2, 16, 4, 6), (3, 4, 4, 32, 8, 4), (1, 8, 1, 64, 16, 3),
             (2, 48, 1, 16, 4, 6)]
# flash_attention: tests/test_kernels.py's sweep (b, s, h, kv, d)
FLASH_SHAPES = [(1, 128, 4, 4, 32), (2, 256, 4, 2, 64), (1, 256, 8, 1, 16)]
FLASH_MASKS = [(True, 0), (True, 64), (False, 0)]
# bf16 edges of the tensor-core flash kernel (b, s, h, kv, d, causal,
# window): one partial key tile (S = 64, 100); rep = H/KV of 1, 3 (63-row
# warpgroups) and 16; D = 16, 32, 64, 80 (zamba2's shared block), 96,
# 128; windows 16, 64 and 200 across the 128-key tiles; non-causal
FLASH_TC_EDGES = [
    (2, 64, 4, 4, 64, True, 0), (2, 100, 6, 2, 32, True, 0),
    (1, 100, 32, 2, 128, False, 0), (2, 256, 3, 1, 96, True, 0),
    (1, 384, 6, 2, 16, True, 16), (1, 512, 32, 2, 128, True, 64),
    (2, 384, 4, 4, 128, True, 200), (1, 256, 16, 1, 64, False, 64),
    (1, 128, 9, 3, 96, False, 200), (2, 512, 16, 16, 32, True, 0),
    (2, 384, 32, 32, 80, True, 0)]


def _flash_inputs(b, s, h, kv, d, seed):
    rng = np.random.default_rng(seed)
    return [rng.normal(size=shape).astype(np.float32)
            for shape in ((b, s, h, d), (b, s, kv, d), (b, s, kv, d))]


def _pa_inputs(b, h, kv, d, bt, mb, seed, n_slots=32):
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(b, h, d)).astype(np.float32)
    kp = rng.normal(size=(n_slots, bt, kv, d)).astype(np.float32)
    vp = rng.normal(size=(n_slots, bt, kv, d)).astype(np.float32)
    lens = rng.integers(1, bt * mb, b).astype(np.int32)
    tables = np.full((b, mb), -1, np.int32)
    for i in range(b):
        used = -(-int(lens[i]) // bt)
        tables[i, :used] = rng.choice(n_slots, used, replace=False)
    return q, kp, vp, tables, lens


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _pa_edges(tables, lens, n_slots, bt, rng):
    """In place, on lanes 0-2 of a batch of at least 4: lane 0 has length 0
    (zeros out, no access bit), lane 1 a -1 hole inside its length, lane 2
    a slot >= n_slots (clamped to the last slot, as XLA's gather clamps)."""
    mb = tables.shape[1]
    lens[0] = 0
    lens[1] = bt * mb - 1
    tables[1] = rng.choice(n_slots, mb, replace=False)
    tables[1, mb // 2] = -1
    lens[2] = max(int(lens[2]), 1)
    tables[2, 0] = n_slots + 3


def _pa_case(b, h, kv, d, bt, mb, seed, kind, dev, dtype):
    """(q, k view, v view, tables, lens) on the card, K and V as strided
    views of one pool [n_slots, 2, bt, KV, D] as kvcache.attend passes
    them. kind: "random" lengths in [1, bt * MB), "full" (every lane at
    bt * MB tokens) or "edges" (`_pa_edges`)."""
    q, kp, vp, tables, lens = _pa_inputs(b, h, kv, d, bt, mb, seed)
    rng = np.random.default_rng(seed + 1)
    if kind == "full":
        lens[:] = bt * mb
        tables = np.stack([rng.choice(kp.shape[0], mb, replace=False)
                           for _ in range(b)]).astype(np.int32)
    elif kind == "edges":
        _pa_edges(tables, lens, kp.shape[0], bt, rng)
    pool = torch.from_numpy(np.stack([kp, vp], axis=1)).to(dev, dtype)
    return (torch.from_numpy(q).to(dev, dtype), pool[:, 0], pool[:, 1],
            torch.from_numpy(tables).to(dev), torch.from_numpy(lens).to(dev))


def _pa_check(args, dtype, want_variant):
    """Runs the kernel once: one launch of the expected variant, out
    within 2e-5 (fp32) / 2e-2 (bf16) of the plain version, access bits
    exact."""
    n0, v0 = tops.launches["paged_attention"], dict(tops.paged_variants)
    got_o, got_t = tops.paged_attention(*args)
    want_o, want_t = tref.paged_attention(*args)
    torch.cuda.synchronize()
    assert tops.launches["paged_attention"] == n0 + 1
    assert tops.paged_variants[want_variant] == v0[want_variant] + 1
    assert sum(tops.paged_variants.values()) == sum(v0.values()) + 1
    tol = 2e-5 if dtype == torch.float32 else 2e-2
    assert got_o.dtype == dtype
    assert (got_o.float() - want_o.float()).abs().max().item() < tol
    assert torch.equal(got_t, want_t)
    return got_o, got_t


def _pa_want(dtype, rep, d):
    """The variant the dispatch rule must pick for aligned pool views: bf16
    with D % 16 == 0 on the tensor cores at any REP."""
    tc = dtype == torch.bfloat16 and d % 16 == 0 and d <= 256
    return tops.TENSOR_CORES if tc else tops.CUDA_CORES


PA_SERVE = (8, 32, 2, 128, 16, 32)   # chatglm3-6b's serve shape
PA_GRANITE = (8, 48, 1, 128, 16, 32)  # granite-20b/34b's decode (REP 48)
PA_QWEN2_VL = (8, 64, 8, 128, 16, 32)  # qwen2-vl-72b's serve shape (REP 8)
# the serve launcher's shapes at --max-len 512 (blocks of max_len / 16 = 32
# tokens, two 16-token passes a page): granite-20b's and glm4-9b's
PA_LAUNCHER = [(8, 48, 1, 128, 32, 16), (8, 32, 2, 128, 32, 16)]


@pytest.mark.gpu
@pytest.mark.parametrize("b,h,kv,d,bt,mb", PA_SHAPES + [PA_SERVE])
@pytest.mark.parametrize("kind", ["random", "full"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_paged_attention_kernel_matches_plain(cuda, b, h, kv, d, bt, mb,
                                              kind, dtype):
    args = _pa_case(b, h, kv, d, bt, mb, d, kind, cuda, dtype)
    _pa_check(args, dtype, _pa_want(dtype, h // kv, d))


@pytest.mark.gpu
@pytest.mark.parametrize("rep", [1, 4, 8, 16, 32, 40, 48])
@pytest.mark.parametrize("d", [16, 64, 128, 256])
@pytest.mark.parametrize("bt", [4, 8, 16, 32])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_paged_attention_kernel_sweep(cuda, rep, d, bt, dtype):
    """REP x D x bt with the edge lanes (length 0, a -1 hole, a clamped
    slot) and a random one; B=4 x KV=2 over MB=6 pages runs one page per
    split, so most splits of the short lanes are empty."""
    b, kv, mb = 4, 2, 6
    assert tops._paged_splits(b, kv, mb, 132) == (mb, 1)
    args = _pa_case(b, rep * kv, kv, d, bt, mb, rep + d + bt, "edges", cuda,
                    dtype)
    out, touched = _pa_check(args, dtype, _pa_want(dtype, rep, d))
    assert not out[0].any() and not touched[0].any()


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_paged_attention_edges_at_serve_shape(cuda, dtype):
    """The serve shape (16 splits of 2 pages, 2 warps a tensor-core block)
    with the edge lanes."""
    args = _pa_case(*PA_SERVE, 5, "edges", cuda, dtype)
    out, _ = _pa_check(args, dtype, _pa_want(dtype, 16, 128))
    assert not out[0].any()


@pytest.mark.gpu
@pytest.mark.parametrize("kind", ["random", "full", "edges"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_paged_attention_granite_decode_shape(cuda, kind, dtype):
    """granite's decode shape (H=48 over one KV head): bf16 on the tensor
    cores in three 16-head groups, fp32 on the CUDA cores in two of 24."""
    want = _pa_want(dtype, 48, 128)
    assert tops._paged_groups(want, 48, 128) == (
        (3, 16) if dtype == torch.bfloat16 else (2, 24))
    args = _pa_case(*PA_GRANITE, 31, kind, cuda, dtype)
    out, touched = _pa_check(args, dtype, want)
    if kind == "edges":
        assert not out[0].any() and not touched[0].any()


@pytest.mark.gpu
@pytest.mark.parametrize("kind", ["random", "full", "edges"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_paged_attention_qwen2_vl_serve_shape(cuda, kind, dtype):
    """qwen2-vl-72b's serve shape (H=64 over KV=8): REP 8, one block per
    KV head; bf16 on the tensor cores."""
    want = _pa_want(dtype, 8, 128)
    assert tops._paged_groups(want, 8, 128)[0] == 1
    args = _pa_case(*PA_QWEN2_VL, 37, kind, cuda, dtype)
    out, touched = _pa_check(args, dtype, want)
    if kind == "edges":
        assert not out[0].any() and not touched[0].any()


@pytest.mark.gpu
@pytest.mark.parametrize("b,h,kv,d,bt,mb", PA_LAUNCHER)
@pytest.mark.parametrize("kind", ["random", "full", "edges"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_paged_attention_launcher_shapes(cuda, b, h, kv, d, bt, mb, kind,
                                         dtype):
    """The serve launcher's 32-token blocks at granite-20b's REP 48 and
    glm4-9b's REP 16: every page past its first 16 tokens."""
    want = _pa_want(dtype, h // kv, d)
    args = _pa_case(b, h, kv, d, bt, mb, 41, kind, cuda, dtype)
    out, touched = _pa_check(args, dtype, want)
    if kind == "edges":
        assert not out[0].any() and not touched[0].any()


@pytest.mark.gpu
def test_paged_attention_unaligned_pool_view(cuda):
    """bf16 pages whose slot stride is no multiple of 8 elements (16-byte
    cp.async cannot read them) go to the CUDA cores and match."""
    b, h, kv, d, bt, mb = 4, 8, 2, 64, 8, 6
    q, kp, vp, tables, lens = _pa_inputs(b, h, kv, d, bt, mb, seed=11)
    n_slots, per = kp.shape[0], bt * kv * d
    flat = torch.zeros(n_slots * (2 * per + 1), dtype=torch.bfloat16,
                       device=cuda)
    shape, stride = (n_slots, bt, kv, d), (2 * per + 1, kv * d, d, 1)
    k = torch.as_strided(flat, shape, stride, 0)
    v = torch.as_strided(flat, shape, stride, per)
    k.copy_(torch.from_numpy(kp))
    v.copy_(torch.from_numpy(vp))
    args = (torch.from_numpy(q).to(cuda, torch.bfloat16), k, v,
            torch.from_numpy(tables).to(cuda), torch.from_numpy(lens).to(cuda))
    _pa_check(args, torch.bfloat16, tops.CUDA_CORES)


@pytest.mark.gpu
@pytest.mark.parametrize("shape", [PA_SERVE, PA_GRANITE])
def test_paged_attention_cuda_graph(cuda, shape):
    """Captured once in a CUDA graph at the serve shape and at granite's
    (REP 48, several blocks per KV head), then replayed after q, seq_lens
    and block_tables change in place: the replay matches the plain version
    on the new inputs (the launch shape depends on shapes only, and the
    call never syncs the host)."""
    args = _pa_case(*shape, 21, "random", cuda, torch.bfloat16)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        tops.paged_attention(*args)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out, touched = tops.paged_attention(*args)
    new = _pa_case(*shape, 22, "edges", cuda, torch.bfloat16)
    for x, y in zip(args, new):
        if x.dim() != 4:
            x.copy_(y)
    graph.replay()
    torch.cuda.synchronize()
    want_o, want_t = tref.paged_attention(*args)
    assert (out.float() - want_o.float()).abs().max().item() < 2e-2
    assert torch.equal(touched, want_t)
    assert not out[0].any()


def _scan_table(n, n_slots, seed, dev):
    from repro_torch.core import object_table as ot
    g = torch.Generator().manual_seed(seed)
    f = [torch.randint(0, hi, (n,), generator=g, dtype=torch.int32)
         for hi in (n_slots + 5, 4, 2, 3, 32)]
    return ot.pack(*f).to(dev)


def _scan_check(table, ct, sb_slots, n_sbs, with_hist, got=None):
    """got (by default a kernel call) equals the plain version exactly."""
    if got is None:
        got = tops.access_scan(table, ct, sb_slots=sb_slots, n_sbs=n_sbs,
                               with_hist=with_hist)
    want = tref.access_scan(table, ct, sb_slots=sb_slots, n_sbs=n_sbs,
                            with_hist=with_hist)
    for x, y in zip(got, want):
        assert x.shape == y.shape and x.dtype == y.dtype
        assert torch.equal(x, y)


# (n, sb_slots, n_sbs): the CPU tests' shapes, n % 4 != 0, the serve
# shape, and 2^20 words over 65536 superblocks (bins past shared memory)
SCAN_SHAPES = [(128, 8, 16), (300, 16, 64), (1, 4, 3), (1027, 8, 100),
               (7168, 16, 672), (1 << 20, 16, 65536)]


@pytest.mark.gpu
@pytest.mark.parametrize("n,sb_slots,n_sbs", SCAN_SHAPES)
@pytest.mark.parametrize("with_hist", [True, False])
def test_access_scan_kernel_matches_plain(cuda, n, sb_slots, n_sbs, with_hist):
    table = _scan_table(n, sb_slots * n_sbs, n, cuda)
    _scan_check(table, torch.tensor(2.5, device=cuda), sb_slots, n_sbs,
                with_hist)


@pytest.mark.gpu
def test_access_scan_unaligned_table(cuda):
    """A table view 4 bytes past a 16-byte boundary takes the scalar pass
    and matches."""
    big = _scan_table(1001, 16 * 64, 7, cuda)
    table = big[1:]
    assert table.data_ptr() % 16 != 0
    for with_hist in (True, False):
        _scan_check(table, torch.tensor(1.0, device=cuda), 16, 64, with_hist)


@pytest.mark.gpu
@pytest.mark.parametrize("with_hist", [True, False])
def test_access_scan_is_one_kernel(cuda, with_hist):
    """A call is exactly one device operation, the kernel: no memset, no
    copy (the scratch was zeroed by the warm-up call)."""
    from torch.profiler import ProfilerActivity, profile
    table = _scan_table(7168, 16 * 672, 3, cuda)
    ct = torch.tensor(2.0, device=cuda)
    kw = dict(sb_slots=16, n_sbs=672, with_hist=with_hist)
    tops.access_scan(table, ct, **kw)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        got = tops.access_scan(table, ct, **kw)
        torch.cuda.synchronize()
    dev = [e.name for e in prof.events()
           if e.device_type == torch.autograd.DeviceType.CUDA]
    assert len(dev) == 1 and "access_scan_kernel" in dev[0], dev
    _scan_check(table, ct, 16, 672, with_hist, got)


@pytest.mark.gpu
@pytest.mark.parametrize("with_hist", [True, False])
def test_access_scan_cuda_graph_resets_scratch(cuda, with_hist):
    """Captured once and replayed on three different tables copied into the
    captured input: each replay is exact, so the kernel left its scratch
    (the histogram's bins, the count and the ticket) zero."""
    n, sb, nsb = 7168, 16, 672
    table = _scan_table(n, sb * nsb, 40, cuda)
    ct = torch.tensor(2.0, device=cuda)
    kw = dict(sb_slots=sb, n_sbs=nsb, with_hist=with_hist)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        tops.access_scan(table, ct, **kw)   # zeroes this stream's scratch
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=side):
        out = tops.access_scan(table, ct, **kw)
    for seed in (41, 42, 43):
        table.copy_(_scan_table(n, sb * nsb, seed, cuda))
        graph.replay()
        torch.cuda.synchronize()
        _scan_check(table, ct, sb, nsb, with_hist, got=out)


@pytest.mark.gpu
def test_access_scan_successive_n_sbs(cuda):
    """Calls that alternate between superblock counts (each its own
    scratch) and between with and without the histogram stay exact."""
    ct = torch.tensor(3.0, device=cuda)
    for i, (n, sb, nsb) in enumerate([(7168, 16, 672), (300, 16, 64),
                                      (7168, 16, 672), (4096, 4, 20000),
                                      (300, 16, 64)] * 2):
        table = _scan_table(n, sb * nsb, 50 + i, cuda)
        _scan_check(table, ct, sb, nsb, with_hist=i % 3 != 1)


# migrate's move lists: the hazards of moving rows in place (chains of
# two in both list orders and a chain of three, a swap, a 3-cycle, a
# self-move beside a plain move, two moves from one source), the edges of
# the semantics (destinations out of range are dropped, sources clamp into
# range, every lane masked), the collector's hot/cold overlap (cold movers
# land in slots hot movers vacate) and a disjoint list (the collector's
# usual pattern)
MIGRATE_KINDS = ("chain", "swap", "cycle3", "self", "fan_out",
                 "dst_out_of_range", "negative_src", "all_masked",
                 "hot_cold", "disjoint")
# which live moves the kernel stages (`ref.migrate_phased`: those on a
# cycle or in the middle of a chain of three), per kind
MIGRATE_STAGED = {"chain": [0, 0, 0, 0, 0, 1, 0], "swap": [1, 1],
                  "cycle3": [1, 1, 1], "self": [1, 0], "fan_out": [0, 0],
                  "dst_out_of_range": [0, 0, 0, 0],
                  "negative_src": [0, 0, 0], "all_masked": [0, 0, 0],
                  "hot_cold": [0, 0, 0, 0, 0, 0]}


def migrate_moves(kind, n_rows, rng):
    """(src [n] int32, dst [n] int32, ok [n] bool) numpy arrays of move
    list `kind` over a pool of n_rows >= 17 rows (its last row the scratch
    row); "disjoint" draws sources and destinations from rng."""
    ok = None
    if kind == "disjoint":
        half = (n_rows - 1) // 2
        m = max(1, half // 2)
        src = rng.choice(half, m, replace=False)
        dst = half + rng.choice(n_rows - 1 - half, m, replace=False)
        ok = rng.random(m) < 0.8
    else:
        src, dst = {
            "chain": ([0, 1, 5, 4, 10, 11, 12], [1, 2, 6, 5, 11, 12, 13]),
            "swap": ([3, 7], [7, 3]),
            "cycle3": ([2, 5, 9], [5, 9, 2]),
            "self": ([4, 6], [4, 8]),
            "fan_out": ([3, 3], [10, 11]),
            "dst_out_of_range": ([2, 3, 4, 5], [n_rows, -1, n_rows + 7, 9]),
            "negative_src": ([-3, -1, 5], [7, 8, 9]),
            "all_masked": ([1, 2, 3], [4, 5, 6]),
            "hot_cold": ([3, 5, 0, 7, 9, 4], [12, 13, 1, 3, 5, 2]),
        }[kind]
        if kind == "all_masked":
            ok = [0, 0, 0]
        elif kind == "hot_cold":
            ok = [1, 1, 0, 1, 1, 0]
        else:
            ok = [1] * len(src)
    return (np.asarray(src, np.int32), np.asarray(dst, np.int32),
            np.asarray(ok, bool))


def _migrate_inputs(kind, n_rows, w, dtype, seed, dev):
    g = torch.Generator().manual_seed(seed)
    data = torch.randn((n_rows, w), generator=g).to(dev, dtype)
    data[-1] = 0
    src, dst, ok = (torch.from_numpy(x).to(dev) for x in
                    migrate_moves(kind, n_rows, np.random.default_rng(seed)))
    return data, src, dst, ok


# (kind, row bytes, dtype, n_rows): every kind at rows of 12 B (4-byte
# copies), 96 B, 1 KiB, 16 KiB and 128 KiB (16-byte copies) in both dtypes,
# 6 B bf16 rows (1-byte copies), and the hot/cold overlap at chatglm3-6b's
# serve pool (10753 rows of 16 KiB)
MIGRATE_CASES = ([(k, rb, dt, 17) for k in MIGRATE_KINDS
                  for rb in (12, 96, 1024, 16384, 131072)
                  for dt in (torch.float32, torch.bfloat16)]
                 + [(k, 6, torch.bfloat16, 17) for k in MIGRATE_KINDS]
                 + [("hot_cold", 16384, torch.bfloat16, 10753)])


@pytest.mark.gpu
@pytest.mark.parametrize("kind,row_bytes,dtype,n_rows", MIGRATE_CASES)
def test_migrate_kernel_matches_plain(cuda, kind, row_bytes, dtype, n_rows):
    """Bit for bit the plain version's and the three-phase model's result;
    the scratch row stays zero."""
    w = row_bytes // torch.tensor([], dtype=dtype).element_size()
    data, src, dst, ok = _migrate_inputs(kind, n_rows, w, dtype, n_rows,
                                         cuda)
    got = tops.migrate(data.clone(), src, dst, ok)
    want = tref.migrate(data.clone(), src, dst, ok)
    phased, staged = tref.migrate_phased(data.clone(), src, dst, ok)
    assert torch.equal(got, want) and torch.equal(phased, want)
    assert not got[-1].any()
    if kind in MIGRATE_STAGED:
        assert staged.tolist() == [bool(x) for x in MIGRATE_STAGED[kind]]


@pytest.mark.gpu
def test_migrate_leaves_scratch_zero(cuda):
    """After every call the stream's scratch (counters, source and
    destination marks) is all zero again, whatever the move list."""
    for i, kind in enumerate(MIGRATE_KINDS * 2):
        data, src, dst, ok = _migrate_inputs(kind, 33, 256, torch.float32,
                                             i, cuda)
        got = tops.migrate(data.clone(), src, dst, ok)
        torch.cuda.synchronize()
        assert torch.equal(got, tref.migrate(data, src, dst, ok))
        key = (got.device.index, torch.cuda.current_stream().cuda_stream, 33)
        assert not tops._mig_scratch[key].any(), kind


@pytest.mark.gpu
def test_migrate_is_one_kernel(cuda):
    """A call is exactly one device operation, the kernel: no memset, no
    copy (the scratch was zeroed by the warm-up call)."""
    from torch.profiler import ProfilerActivity, profile
    data, src, dst, ok = _migrate_inputs("hot_cold", 600, 256,
                                         torch.float32, 5, cuda)
    tops.migrate(data.clone(), src, dst, ok)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        tops.migrate(data, src, dst, ok)
        torch.cuda.synchronize()
    dev = [e.name for e in prof.events()
           if e.device_type == torch.autograd.DeviceType.CUDA]
    assert len(dev) == 1 and "migrate_kernel" in dev[0], dev


@pytest.mark.gpu
def test_migrate_cuda_graph_is_one_kernel_node(cuda):
    """Captured on a stream that called it before, a call is one kernel
    node that carries the cooperative attribute, and nothing else (no
    memset); replays on three pools copied into the captured input, with
    the hot/cold overlap and a disjoint list, each equal the eager call."""
    n_rows, w = 2049, 256
    perm = torch.randperm(n_rows - 1,
                          generator=torch.Generator().manual_seed(3))
    src = torch.cat([perm[:256], perm[256:512]]).to(cuda, torch.int32)
    dst = torch.cat([perm[512:768], perm[:256]]).to(cuda, torch.int32)
    ok = (torch.arange(512) % 7 != 3).to(cuda)
    data = torch.zeros((n_rows, w), device=cuda)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        tops.migrate(data, src, dst, ok)   # zeroes this stream's scratch
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph(keep_graph=True)
    with torch.cuda.graph(graph, stream=side):
        tops.migrate(data, src, dst, ok)
    assert tops.graph_nodes(graph) == dict(nodes=1, kernels=1, cooperative=1)
    for seed, disjoint in ((41, False), (42, True), (43, False)):
        if disjoint:
            dst.copy_(perm[768:1280].to(cuda, torch.int32))
        pool = torch.randn((n_rows, w), generator=torch.Generator()
                           .manual_seed(seed)).to(cuda)
        pool[-1] = 0
        data.copy_(pool)
        graph.replay()
        torch.cuda.synchronize()
        assert torch.equal(data, tops.migrate(pool.clone(), src, dst, ok))
        assert torch.equal(data, tref.migrate(pool, src, dst, ok))
        key = (cuda.index or 0, side.cuda_stream, n_rows)
        assert not tops._mig_scratch[key].any()


@pytest.mark.gpu
def test_empty_inputs_launch_nothing(cuda):
    """A wrapper given nothing to do returns the plain version's result and
    counts no launch."""
    before = dict(tops.launches)
    data = torch.ones((5, 8), device=cuda)
    none = torch.zeros(0, dtype=torch.int32, device=cuda)
    got = tops.migrate(data, none, none, none.bool())
    assert torch.equal(got, torch.ones_like(data))
    ct = torch.tensor(2.0, device=cuda)
    for x, y in zip(tops.access_scan(none, ct, sb_slots=4, n_sbs=3),
                    tref.access_scan(none, ct, sb_slots=4, n_sbs=3)):
        assert torch.equal(x, y)
    q = torch.zeros((0, 8, 16), device=cuda)
    pages = torch.zeros((4, 4, 2, 16), device=cuda)
    tables = torch.zeros((0, 3), dtype=torch.int32, device=cuda)
    out, touched = tops.paged_attention(q, pages, pages, tables,
                                        none[:0])
    assert out.shape == (0, 8, 16) and touched.shape == (0, 3)
    assert tops.launches == before


@pytest.mark.gpu
@pytest.mark.parametrize("b,s,h,kv,d", FLASH_SHAPES + [
    (1, 512, 32, 2, 128), (2, 384, 6, 3, 96), (1, 100, 4, 2, 256)])
@pytest.mark.parametrize("causal,window", FLASH_MASKS + [(False, 16)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_attention_kernel_matches_plain(cuda, b, s, h, kv, d, causal,
                                              window, dtype):
    q, k, v = (torch.from_numpy(x).to(cuda, dtype)
               for x in _flash_inputs(b, s, h, kv, d, seed=s + d))
    n0 = tops.launches["flash_attention"]
    got = tops.flash_attention(q, k, v, causal=causal, window=window)
    want = tref.flash_attention(q, k, v, causal=causal, window=window)
    torch.cuda.synchronize()
    assert tops.launches["flash_attention"] == n0 + 1
    assert got.dtype == dtype and got.shape == (b, s, h, d)
    tol = 2e-5 if dtype == torch.float32 else 2e-2
    assert (got.float() - want.float()).abs().max().item() < tol


@pytest.mark.gpu
def test_flash_attention_edge_cases(cuda):
    """Empty input counts no launch; S=200 raises before dispatch; q as a
    strided view of a fused projection (unit stride along D) is taken and
    matches the plain version, and a view without unit stride along D is
    refused with ValueError."""
    n0 = tops.launches["flash_attention"]
    empty = torch.zeros((0, 128, 4, 16), device=cuda)
    assert tops.flash_attention(empty, empty, empty).shape == (0, 128, 4, 16)
    q, k, v = (torch.from_numpy(x).to(cuda)
               for x in _flash_inputs(1, 200, 4, 2, 16, seed=0))
    with pytest.raises(ValueError, match="S=200"):
        tops.flash_attention(q, k, v)
    assert tops.launches["flash_attention"] == n0

    b, s, h, kv, d = 2, 256, 8, 2, 32
    g = torch.Generator(device=cuda).manual_seed(0)
    fused = torch.randn((b, s, (h + 2 * kv) * d), generator=g, device=cuda)
    q = fused[..., :h * d].view(b, s, h, d)
    k = fused[..., h * d:(h + kv) * d].view(b, s, kv, d)
    v = fused[..., (h + kv) * d:].view(b, s, kv, d)
    assert not q.is_contiguous()
    got = tops.flash_attention(q, k, v)
    want = tref.flash_attention(q.contiguous(), k.contiguous(),
                                v.contiguous())
    torch.cuda.synchronize()
    assert (got - want).abs().max().item() < 2e-5
    assert tops.launches["flash_attention"] == n0 + 1
    qt = q.contiguous().transpose(1, 3).contiguous().transpose(1, 3)
    assert qt.stride(3) != 1
    with pytest.raises(ValueError, match="unit stride"):
        tops.flash_attention(qt, k, v)


def _variant_run(fn):
    """fn()'s result and the flash_attention variant it launched."""
    before = dict(tops.flash_variants)
    out = fn()
    torch.cuda.synchronize()
    ran = [k for k in before if tops.flash_variants[k] != before[k]]
    assert len(ran) == 1 and tops.flash_variants[ran[0]] == before[ran[0]] + 1
    return out, ran[0]


@pytest.mark.gpu
@pytest.mark.parametrize("b,s,h,kv,d,causal,window", FLASH_TC_EDGES)
def test_flash_attention_tensor_core_edges(cuda, b, s, h, kv, d, causal,
                                           window):
    """bf16 at the tensor-core kernel's edges, within 2e-2 of the plain
    version, and the dispatch rule picked that kernel."""
    q, k, v = (torch.from_numpy(x).to(cuda, torch.bfloat16)
               for x in _flash_inputs(b, s, h, kv, d, seed=s + d + window))
    got, variant = _variant_run(
        lambda: tops.flash_attention(q, k, v, causal=causal, window=window))
    want = tref.flash_attention(q, k, v, causal=causal, window=window)
    assert variant == tops.TENSOR_CORES
    assert got.dtype == torch.bfloat16 and got.shape == (b, s, h, d)
    assert (got.float() - want.float()).abs().max().item() < 2e-2


@pytest.mark.gpu
def test_flash_attention_bf16_views(cuda):
    """bf16 q/k/v as strided views of a fused projection go to the tensor
    cores through their strides; a view TMA cannot describe (a position
    stride that is no multiple of 8 elements, a base 2 bytes past
    alignment) goes to the CUDA cores; both match the plain version within
    2e-2."""
    b, s, h, kv, d = 2, 256, 8, 2, 64
    g = torch.Generator(device=cuda).manual_seed(1)
    fused = torch.randn((b, s, (h + 2 * kv) * d), generator=g,
                        device=cuda).bfloat16()
    q = fused[..., :h * d].view(b, s, h, d)
    k = fused[..., h * d:(h + kv) * d].view(b, s, kv, d)
    v = fused[..., (h + kv) * d:].view(b, s, kv, d)
    odd = torch.randn((b, s, h * d + 1), generator=g, device=cuda).bfloat16()
    q_odd = odd[..., 1:].view(b, s, h, d)
    assert q_odd.stride(1) % 8 != 0 and q_odd.data_ptr() % 16 != 0
    for qq, want_variant in ((q, tops.TENSOR_CORES),
                             (q_odd, tops.CUDA_CORES)):
        got, variant = _variant_run(lambda: tops.flash_attention(qq, k, v))
        want = tref.flash_attention(qq.contiguous(), k.contiguous(),
                                    v.contiguous())
        assert variant == want_variant
        assert (got.float() - want.float()).abs().max().item() < 2e-2


# the prefill shapes of the encoder-decoder and VLM families (b, s, h, kv,
# d, causal): seamless-m4t-large-v2's encoder (non-causal over 1024
# frames) and decoder, qwen2-vl-72b's GQA (REP 8) at D = 128, and
# granite-20b / 34b's MQA (H = 48 over one KV head)
FLASH_FAMILY_SHAPES = [(2, 1024, 16, 16, 64, False),
                       (2, 4096, 16, 16, 64, True),
                       (2, 4096, 64, 8, 128, True),
                       (2, 4096, 48, 1, 128, True)]


@pytest.mark.gpu
@pytest.mark.parametrize("b,s,h,kv,d,causal", FLASH_FAMILY_SHAPES)
def test_flash_attention_family_shapes(cuda, b, s, h, kv, d, causal):
    """bf16 on the tensor cores within 2e-2 of the plain version."""
    q, k, v = (torch.from_numpy(x).to(cuda, torch.bfloat16)
               for x in _flash_inputs(b, s, h, kv, d, seed=h + d))
    got, variant = _variant_run(
        lambda: tops.flash_attention(q, k, v, causal=causal))
    want = tref.flash_attention(q, k, v, causal=causal)
    assert variant == tops.TENSOR_CORES
    assert (got.float() - want.float()).abs().max().item() < 2e-2


@pytest.mark.gpu
@pytest.mark.parametrize("arch", ["seamless-m4t-large-v2", "qwen2-vl-72b"])
def test_encdec_and_vlm_on_card_match_cpu(cuda, monkeypatch, arch):
    """The reduced encoder-decoder and VLM, float32, attn_impl "flash", on
    the card (flash_attention's CUDA-core kernel for fp32) against the CPU
    (its plain version): one flash_attention launch per encoder and
    decoder layer and no other kernel in a prefill (with frame or patch
    embeddings), none in a decode step; logits within 1e-4 (fp32 sums in
    another order)."""
    import dataclasses
    from repro_torch.configs import get_config
    from repro_torch.models.model import Model
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", False)
    cfg = dataclasses.replace(get_config(arch, reduced=True),
                              dtype="float32")
    m_cpu = Model(cfg, attn_impl="flash", device="cpu")
    m_gpu = Model(cfg, attn_impl="flash", device="cuda")
    p_cpu = m_cpu.init(torch.Generator().manual_seed(0))
    p_gpu = _to(p_cpu, cuda)
    rng = np.random.default_rng(0)
    batch = {"tokens": torch.from_numpy(rng.integers(0, cfg.vocab_size,
                                                     (2, 12)))}
    key = "enc_embeds" if cfg.is_encoder_decoder else "extra_embeds"
    n = cfg.encoder_seq_len if cfg.is_encoder_decoder else 4
    batch[key] = torch.from_numpy(rng.normal(size=(2, n, cfg.d_model))
                                  .astype(np.float32))
    tops.reset_launches()
    lg = m_gpu.prefill(p_gpu, _to(batch, cuda))
    n_attn = cfg.num_layers + (cfg.num_encoder_layers
                               if cfg.is_encoder_decoder else 0)
    assert tops.launches["flash_attention"] == n_attn
    assert sum(tops.launches.values()) == n_attn
    lc = m_cpu.prefill(p_cpu, batch)
    assert (lc - lg.cpu()).abs().max().item() < 1e-4
    enc = None
    if cfg.is_encoder_decoder:
        from repro_torch.models.transformer import encoder_forward
        enc = encoder_forward(p_cpu, cfg, batch["enc_embeds"])
    s_cpu = m_cpu.init_decode_state(2, 8, enc_out=enc)
    s_gpu = m_gpu.init_decode_state(2, 8, enc_out=None if enc is None
                                    else enc.to(cuda))
    for t in range(4):
        tops.reset_launches()
        tok = batch["tokens"][:, t]
        dg, s_gpu = m_gpu.decode_step(p_gpu, s_gpu, tok.to(cuda))
        assert sum(tops.launches.values()) == 0
        dc, s_cpu = m_cpu.decode_step(p_cpu, s_cpu, tok)
        assert (dc - dg.cpu()).abs().max().item() < 1e-4


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}/"))
        else:
            out[f"{prefix}{k}"] = v
    return out


def _to(tree, dev):
    if isinstance(tree, dict):
        return {k: _to(v, dev) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_to(v, dev) for v in tree]
    return tree.to(dev)


@pytest.mark.gpu
def test_server_on_card_matches_cpu(cuda, monkeypatch):
    """The slice on the card (CUDA kernels) against the CPU (plain
    versions), float32, chatglm3-6b reduced: identical greedy tokens,
    Completions, reports and pool metadata; logits within 1e-4 and pool
    data within 1e-5 (fp32 sums in another order); every kernel of the
    serving path launched, and flash_attention (prefill only) never."""
    import dataclasses
    from repro_torch.configs import get_config
    from repro_torch.core import engine as eng
    from repro_torch.models.model import Model
    from repro_torch.runtime.server import Request, Server, ServerConfig
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", False)
    cfg = dataclasses.replace(get_config("chatglm3-6b", reduced=True),
                              dtype="float32")
    kw = dict(batch=2, max_len=32, block_tokens=4, collect_every=4,
              overlap_collect=True)
    m_cpu, m_gpu = Model(cfg, device="cpu"), Model(cfg, device="cuda")
    p_cpu = m_cpu.init(torch.Generator().manual_seed(0))
    p_gpu = _to(p_cpu, cuda)
    s_cpu, s_gpu = (Server(m_cpu, ServerConfig(**kw)),
                    Server(m_gpu, ServerConfig(**kw)))
    toks = np.random.default_rng(0).integers(0, 256, (2, 10))
    n0 = dict(tops.launches)
    lc, tc, rc = s_cpu.decode_window(p_cpu, toks)
    lg, tg, rg = s_gpu.decode_window(p_gpu, toks)
    assert (lc - lg.cpu()).abs().max().item() < 1e-4
    assert torch.equal(tc, tg.cpu())
    assert eng.window_reports(rc) == eng.window_reports(rg)
    assert all(tops.launches[k] > n0[k]
               for k in ("paged_attention", "access_scan", "migrate"))
    assert tops.launches["flash_attention"] == n0["flash_attention"]
    fc, fg = _flat(s_cpu.state), _flat(s_gpu.state)
    for k in fc:
        if k.endswith("data"):
            assert (fc[k] - fg[k].cpu()).abs().max().item() < 1e-5
        else:
            assert torch.equal(fc[k], fg[k].cpu()), k

    rng = np.random.default_rng(1)
    reqs = [Request(prompt=rng.integers(0, 256, int(rng.integers(2, 9)))
                    .tolist(), max_new=int(rng.integers(3, 9)))
            for _ in range(5)]
    r_cpu, r_gpu = s_cpu.serve(p_cpu, reqs), s_gpu.serve(p_gpu, reqs)
    assert [dataclasses.asdict(r) for r in r_cpu] == \
        [dataclasses.asdict(r) for r in r_gpu]
    assert s_cpu.reports == s_gpu.reports
    assert s_gpu.dispatches == len(s_gpu.serve_log)
    assert s_gpu.kv_rss_bytes() == 0.0


# mamba_scan: tests/test_kernels.py's sweep (b, s, c, n), falcon-mamba's
# decode shape (S=1), and lane counts B*C*N that are not a multiple of
# the kernel's 128-thread block, with S not a multiple of its unroll
SCAN_SHAPES = [(1, 64, 8, 16), (2, 128, 16, 8), (1, 32, 4, 4),
               (8, 1, 8192, 16), (3, 13, 7, 9), (1, 1003, 5, 3)]


def _scan_inputs(b, s, c, n, dev, dtype, seed):
    rng = np.random.default_rng(seed)
    a = rng.uniform(0.3, 1.0, (b, s, c, n)).astype(np.float32)
    bb = rng.normal(size=(b, s, c, n)).astype(np.float32)
    h0 = rng.normal(size=(b, c, n)).astype(np.float32)
    return (torch.from_numpy(a).to(dev, dtype),
            torch.from_numpy(bb).to(dev, dtype), torch.from_numpy(h0).to(dev))


@pytest.mark.gpu
@pytest.mark.parametrize("b,s,c,n", SCAN_SHAPES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_mamba_scan_kernel_matches_plain(cuda, b, s, c, n, dtype):
    """Bit for bit: both compute each step as a rounded product and a
    rounded sum in fp32."""
    a, bb, h0 = _scan_inputs(b, s, c, n, cuda, dtype, seed=s * c + n)
    n0 = tops.launches["mamba_scan"]
    got_all, got_last = tops.mamba_scan(a, bb, h0)
    want_all, want_last = tref.mamba_scan(a, bb, h0)
    torch.cuda.synchronize()
    assert tops.launches["mamba_scan"] == n0 + 1
    assert got_all.dtype == got_last.dtype == torch.float32
    assert torch.equal(got_all, want_all) and torch.equal(got_last, want_last)


@pytest.mark.gpu
def test_mamba_scan_refuses_bad_inputs(cuda):
    """Non-contiguous or mistyped inputs raise ValueError before any
    launch; an empty sequence returns h0 and launches nothing."""
    a, bb, h0 = _scan_inputs(2, 8, 4, 4, cuda, torch.float32, seed=0)
    n0 = tops.launches["mamba_scan"]
    with pytest.raises(ValueError, match="contiguous"):
        tops.mamba_scan(a.transpose(2, 3), bb.transpose(2, 3), h0)
    with pytest.raises(ValueError, match="one dtype"):
        tops.mamba_scan(a, bb.bfloat16(), h0)
    with pytest.raises(ValueError, match="one dtype"):
        tops.mamba_scan(a.half(), bb.half(), h0)
    with pytest.raises(ValueError, match="h0 must be float32"):
        tops.mamba_scan(a, bb, h0.bfloat16())
    with pytest.raises(ValueError, match="h0"):
        tops.mamba_scan(a, bb, h0[:1])
    h_all, h_last = tops.mamba_scan(a[:, :0], bb[:, :0], h0)
    assert h_all.shape == (2, 0, 4, 4) and torch.equal(h_last, h0)
    assert tops.launches["mamba_scan"] == n0


@pytest.mark.gpu
def test_falcon_mamba_on_card_matches_cpu(cuda, monkeypatch):
    """falcon-mamba-7b reduced, float32, on the card (the mamba_scan
    kernel) against the CPU (its plain version): one launch per layer in a
    prefill and in each decode step, no other kernel; logits within 1e-4
    (fp32 sums in another order)."""
    import dataclasses
    from repro_torch.configs import get_config
    from repro_torch.models.model import Model
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", False)
    cfg = dataclasses.replace(get_config("falcon-mamba-7b", reduced=True),
                              dtype="float32")
    m_cpu, m_gpu = Model(cfg, device="cpu"), Model(cfg, device="cuda")
    p_cpu = m_cpu.init(torch.Generator().manual_seed(0))
    p_gpu = _to(p_cpu, cuda)
    toks = torch.from_numpy(np.random.default_rng(0).integers(0, 256, (2, 16)))
    tops.reset_launches()
    lg = m_gpu.prefill(p_gpu, {"tokens": toks.to(cuda)})
    assert tops.launches["mamba_scan"] == cfg.num_layers
    assert sum(tops.launches.values()) == cfg.num_layers
    lc = m_cpu.prefill(p_cpu, {"tokens": toks})
    assert (lc - lg.cpu()).abs().max().item() < 1e-4
    s_cpu, s_gpu = m_cpu.init_decode_state(2, 16), m_gpu.init_decode_state(2, 16)
    for t in range(4):
        tops.reset_launches()
        dg, s_gpu = m_gpu.decode_step(p_gpu, s_gpu, toks[:, t].to(cuda))
        assert tops.launches["mamba_scan"] == cfg.num_layers
        assert sum(tops.launches.values()) == cfg.num_layers
        dc, s_cpu = m_cpu.decode_step(p_cpu, s_cpu, toks[:, t])
        assert (dc - dg.cpu()).abs().max().item() < 1e-4
    for k in ("h", "conv"):
        assert (s_cpu["ssm"][k] - s_gpu["ssm"][k].cpu()).abs().max().item() \
            < 1e-4


@pytest.mark.gpu
@pytest.mark.parametrize("s,chunk,with_state", [(256, 128, False),
                                                (24, 8, True), (1, 1, True)])
def test_mamba2_forward_kernel_matches_plain(cuda, monkeypatch, s, chunk,
                                             with_state):
    """A zamba2-reduced mamba2 block in float32 on the card: its chunk
    carry through the mamba_scan kernel (one launch a call) against the
    same call with the plain version patched in, bit for bit (the kernel
    and its plain version agree bit for bit, and every other op is the
    same call on the same card)."""
    import dataclasses
    from repro_torch.configs import get_config
    from repro_torch.models import ssm
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", False)
    cfg = dataclasses.replace(get_config("zamba2-2.7b", reduced=True),
                              dtype="float32")
    p = ssm.init_mamba2(cfg, torch.float32,
                        torch.Generator(device=cuda).manual_seed(0), cuda)
    g = torch.Generator(device=cuda).manual_seed(1)
    x = torch.randn((2, s, cfg.d_model), generator=g, device=cuda)
    state = None
    if with_state:
        state = {k: torch.randn(v.shape, generator=g, device=cuda).to(v.dtype)
                 * 0.5 for k, v in ssm.mamba2_init_state(
                     cfg, 2, torch.float32, cuda).items()}
    n0 = tops.launches["mamba_scan"]
    y, new = ssm.mamba2_forward(p, x, cfg, chunk=chunk, state=state)
    assert tops.launches["mamba_scan"] == n0 + 1
    monkeypatch.setattr(tops, "mamba_scan", tref.mamba_scan)
    y_ref, new_ref = ssm.mamba2_forward(p, x, cfg, chunk=chunk, state=state)
    torch.cuda.synchronize()
    assert torch.equal(y, y_ref)
    assert all(torch.equal(new[k], new_ref[k]) for k in new)


@pytest.mark.gpu
def test_zamba2_on_card_matches_cpu(cuda, monkeypatch):
    """zamba2-2.7b reduced, float32, on the card (the mamba_scan kernel for
    every mamba2 block's carry, flash_attention's CUDA-core kernel for the
    shared block's fp32 prefill) against the CPU (their plain versions):
    a prefill of S=256 (two SSD chunks) launches one mamba_scan per mamba2
    block and one flash_attention per group, a decode step one mamba_scan
    per block and nothing else; logits and states within 1e-4 (fp32 sums
    in another order)."""
    import dataclasses
    from repro_torch.configs import get_config
    from repro_torch.models.model import Model
    from repro_torch.models.transformer import _hybrid_shape
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", False)
    cfg = dataclasses.replace(get_config("zamba2-2.7b", reduced=True),
                              dtype="float32")
    per, groups = _hybrid_shape(cfg)
    m_cpu = Model(cfg, attn_impl="flash", device="cpu")
    m_gpu = Model(cfg, attn_impl="flash", device="cuda")
    p_cpu = m_cpu.init(torch.Generator().manual_seed(0))
    p_gpu = _to(p_cpu, cuda)
    toks = torch.from_numpy(np.random.default_rng(0).integers(0, 256,
                                                              (2, 256)))
    tops.reset_launches()
    lg = m_gpu.prefill(p_gpu, {"tokens": toks.to(cuda)})
    assert tops.launches["mamba_scan"] == per * groups
    assert tops.launches["flash_attention"] == groups
    assert sum(tops.launches.values()) == (per + 1) * groups
    lc = m_cpu.prefill(p_cpu, {"tokens": toks})
    assert (lc - lg.cpu()).abs().max().item() < 1e-4
    s_cpu, s_gpu = m_cpu.init_decode_state(2, 8), m_gpu.init_decode_state(2, 8)
    for t in range(4):
        tops.reset_launches()
        dg, s_gpu = m_gpu.decode_step(p_gpu, s_gpu, toks[:, t].to(cuda))
        assert tops.launches["mamba_scan"] == per * groups
        assert sum(tops.launches.values()) == per * groups
        dc, s_cpu = m_cpu.decode_step(p_cpu, s_cpu, toks[:, t])
        assert (dc - dg.cpu()).abs().max().item() < 1e-4
    for part in ("ssm", "kv"):
        for k, v in s_cpu[part].items():
            assert (v.float() - s_gpu[part][k].cpu().float()).abs().max() \
                .item() < 1e-4, (part, k)


@pytest.mark.gpu
@pytest.mark.parametrize("b,s,c,n", SCAN_SHAPES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_mamba_scan_bwd_kernel_matches_plain(cuda, b, s, c, n, dtype):
    """The backward kernel against `ref.mamba_scan_bwd`, bit for bit (both
    take each step as a rounded sum and rounded products in fp32), one
    launch a call; on a non-contiguous gradient too (made contiguous)."""
    a, bb, h0 = _scan_inputs(b, s, c, n, cuda, dtype, seed=s * c + n + 1)
    h_all, _ = tref.mamba_scan(a, bb, h0)
    g = torch.Generator(device=cuda).manual_seed(s + c)
    dh_all = torch.randn(h_all.shape, generator=g, device=cuda)
    dh_last = torch.randn(h0.shape, generator=g, device=cuda)
    n0 = tops.launches["mamba_scan_bwd"]
    got = tops.mamba_scan_bwd(a, h0, h_all, dh_all, dh_last)
    want = tref.mamba_scan_bwd(a, h0, h_all, dh_all, dh_last)
    torch.cuda.synchronize()
    assert tops.launches["mamba_scan_bwd"] == n0 + 1
    assert [x.dtype for x in got] == [dtype, dtype, torch.float32]
    assert all(torch.equal(x, y) for x, y in zip(got, want))
    strided = dh_all.transpose(2, 3).contiguous().transpose(2, 3)
    again = tops.mamba_scan_bwd(a, h0, h_all, strided, dh_last)
    assert all(torch.equal(x, y) for x, y in zip(again, want))


@pytest.mark.gpu
def test_mamba_scan_grad_through_kernels(cuda):
    """`ops.mamba_scan` under autograd on the card: forward and backward
    kernels, one launch each, gradients bit for bit autograd's through the
    plain loop; an empty sequence launches nothing."""
    a, bb, h0 = _scan_inputs(2, 37, 8, 16, cuda, torch.float32, seed=4)
    g = torch.Generator(device=cuda).manual_seed(0)
    dh_all = torch.randn(a.shape, generator=g, device=cuda)
    dh_last = torch.randn(h0.shape, generator=g, device=cuda)
    grads = []
    for scan in (tops.mamba_scan, tref.mamba_scan):
        ins = [t.clone().requires_grad_() for t in (a, bb, h0)]
        tops.reset_launches()
        out = scan(*ins)
        grads.append(torch.autograd.grad(out, ins, [dh_all, dh_last]))
        if scan is tops.mamba_scan:
            assert tops.launches["mamba_scan"] == 1
            assert tops.launches["mamba_scan_bwd"] == 1
    assert all(torch.equal(x, y) for x, y in zip(*grads))
    ins = [t.clone().requires_grad_() for t in (a[:, :0], bb[:, :0], h0)]
    tops.reset_launches()
    out = tops.mamba_scan(*ins)
    da, db, dh0 = torch.autograd.grad(out[1], ins, dh_last)
    assert torch.equal(dh0, dh_last) and da.shape == (2, 0, 8, 16)
    assert sum(tops.launches.values()) == 0


def _block_grads(fn, p, x):
    leaves = [x] + list(p.values())
    for t in leaves:
        t.requires_grad_(True)
    try:
        y, _ = fn(p, x)
        return torch.autograd.grad(y.square().sum(), leaves)
    finally:
        for t in leaves:
            t.requires_grad_(False)


@pytest.mark.gpu
@pytest.mark.parametrize("kind", ["mamba1", "mamba2"])
def test_mamba_block_grads_kernel_match_plain(cuda, monkeypatch, kind):
    """The gradients of a falcon-mamba-reduced mamba1 block and a zamba2-
    reduced mamba2 block in float32 on the card, through the kernels,
    against the same call with the plain version patched in (autograd
    through its loop). The scan's gradients agree bit for bit, so the
    kernel-vs-plain gap may be no larger than the gap between two kernel
    runs (0 unless a library op around them is not deterministic)."""
    import dataclasses
    from repro_torch.configs import get_config
    from repro_torch.models import ssm
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", False)
    arch, init, fwd, s = {
        "mamba1": ("falcon-mamba-7b", ssm.init_mamba1, ssm.mamba1_forward,
                   64),
        "mamba2": ("zamba2-2.7b", ssm.init_mamba2, ssm.mamba2_forward,
                   256)}[kind]
    cfg = dataclasses.replace(get_config(arch, reduced=True),
                              dtype="float32")
    p = init(cfg, torch.float32, torch.Generator(device=cuda).manual_seed(0),
             cuda)
    x = torch.randn((2, s, cfg.d_model), device=cuda,
                    generator=torch.Generator(device=cuda).manual_seed(1))

    def run(p_, x_):
        return fwd(p_, x_, cfg)
    tops.reset_launches()
    k1 = _block_grads(run, p, x)
    assert tops.launches["mamba_scan"] == tops.launches["mamba_scan_bwd"] \
        == 1
    k2 = _block_grads(run, p, x)
    monkeypatch.setattr(tops, "mamba_scan", tref.mamba_scan)
    plain = _block_grads(run, p, x)
    torch.cuda.synchronize()
    for a, b, c in zip(k1, k2, plain):
        assert (a - c).abs().max().item() <= (a - b).abs().max().item()
    assert all(g.abs().max().item() > 0 for g in k1)


@pytest.mark.gpu
def test_zamba2_train_step_on_card_matches_cpu(cuda, monkeypatch, tmp_path):
    """zamba2-2.7b reduced, float32, remat "full": two `Trainer.run` steps
    on the card (the scan's forward and backward kernels) against the
    same steps on the CPU (their plain versions): each step launches
    mamba_scan twice per mamba2 block (forward and recompute) and
    mamba_scan_bwd once; losses and grad norms within 1e-4, params after
    within 1e-5 (fp32 sums in another order, as on the CPU against JAX)."""
    from repro_torch.configs import get_config
    from repro_torch.data.lm import DataConfig
    from repro_torch.models.model import Model
    from repro_torch.models.transformer import _hybrid_shape
    from repro_torch.optim.adamw import AdamWConfig
    from repro_torch.runtime.trainer import Trainer, TrainerConfig
    from repro_torch import tree as tree_lib
    import dataclasses
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", False)
    cfg = dataclasses.replace(get_config("zamba2-2.7b", reduced=True),
                              dtype="float32")
    per, groups = _hybrid_shape(cfg)
    dcfg = DataConfig(vocab_size=cfg.vocab_size, seq_len=256, global_batch=2)
    ocfg = AdamWConfig(total_steps=2, warmup_steps=1)
    outs = {}
    for dev in ("cpu", "cuda"):
        m = Model(cfg, remat="full", device=dev)
        p = _to(Model(cfg, device="cpu").init(
            torch.Generator().manual_seed(0)), dev)
        tops.reset_launches()
        outs[dev] = Trainer(m, dcfg, ocfg, TrainerConfig(
            ckpt_dir=str(tmp_path / dev), log_every=1)).run(p, 2)
        if dev == "cuda":
            assert tops.launches["mamba_scan"] == 2 * 2 * per * groups
            assert tops.launches["mamba_scan_bwd"] == 2 * per * groups
            assert sum(tops.launches.values()) == 2 * 3 * per * groups
    for (_, c), (_, g) in zip(outs["cpu"]["history"],
                              outs["cuda"]["history"]):
        assert abs(c["loss"] - g["loss"]) < 1e-4
        assert abs(c["grad_norm"] - g["grad_norm"]) < 1e-4 * c["grad_norm"]
    for x, y in zip(tree_lib.leaves(outs["cpu"]["params"]),
                    tree_lib.leaves(outs["cuda"]["params"])):
        assert (x - y.cpu()).abs().max().item() < 1e-5


# ---------------------------------------------------------------------------
# the serve window as one CUDA graph replay
# ---------------------------------------------------------------------------
BACKENDS = ("null", "proactive", "reactive", "cap", "mglru", "promote")


def _graph_pair(backend="proactive", dtype="float32", overlap=False,
                arch="chatglm3-6b"):
    """(model, params, graph server, eager server): `arch` reduced on the
    card, W = 2 * collect_every, the backend under full pressure."""
    import dataclasses
    from repro_torch.configs import get_config
    from repro_torch.core import backend as be
    from repro_torch.models.model import Model
    from repro_torch.runtime.server import Server, ServerConfig
    cfg = dataclasses.replace(get_config(arch, reduced=True), dtype=dtype)
    model = Model(cfg, device="cuda")
    params = model.init(torch.Generator(device="cuda").manual_seed(0))
    bp = be.pressure_params(backend, 1)
    kw = dict(batch=2, max_len=32, block_tokens=4, collect_every=4, window=8,
              overlap_collect=overlap, backend=backend,
              backend_params=dict(bp, min_evict_gen=0)
              if backend == "mglru" else bp)
    graph, eager = Server(model, ServerConfig(**kw)), \
        Server(model, ServerConfig(**kw))
    eager._eager = True
    return model, params, graph, eager


def _graph_requests(seed, temperature=0.0):
    from repro_torch.runtime.server import Request
    rng = np.random.default_rng(seed)
    return [Request(prompt=rng.integers(0, 256, int(rng.integers(2, 9)))
                    .tolist(), max_new=int(rng.integers(3, 12)),
                    temperature=temperature, top_k=8 if temperature else 0)
            for _ in range(6)]


def _counted(fn):
    snap = tops.count_snapshot()
    out = fn()
    torch.cuda.synchronize()
    return out, tops.counts_since(snap)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("backend", BACKENDS)
def test_graph_serve_matches_eager(cuda, backend, dtype):
    """Two serve calls on one server (the second through `reset`), each
    window after the first a graph replay, against the same calls op by
    op: identical Completions, reports, per-window gauges, every leaf of
    the state (pool data included) bit for bit, and the same kernel
    launches counted; the pool's `data` never leaves its storage."""
    import dataclasses
    _, params, g, e = _graph_pair(backend, dtype, overlap=dtype == "bfloat16")
    ptr = None
    for call in range(2):
        reqs = _graph_requests(call)
        rg, cg = _counted(lambda: g.serve(params, reqs))
        re_, ce = _counted(lambda: e.serve(params, reqs))
        assert [dataclasses.asdict(r) for r in rg] == \
            [dataclasses.asdict(r) for r in re_], call
        assert g.reports == e.reports and g.serve_log == e.serve_log
        assert cg == ce and cg["launches"]["paged_attention"] > 0, (cg, ce)
        fg, fe = _flat(g.state), _flat(e.state)
        assert sorted(fg) == sorted(fe)
        for k in fg:
            assert torch.equal(fg[k], fe[k]), (call, k)
        data = g.state["pool"]["data"]
        ptr = ptr or data.untyped_storage().data_ptr()
        assert data.untyped_storage().data_ptr() == ptr
        assert g.dispatches == len(g.serve_log) > 2
    assert len(g._graphs) == 1 and not e._graphs


@pytest.mark.gpu
def test_graph_sampled_serve_matches_eager(cuda):
    """Sampled requests from the same generator seed: identical tokens,
    graph against eager, the sampled program replaying with the server's
    generator registered; another seed draws other tokens."""
    _, params, g, e = _graph_pair()
    reqs = _graph_requests(5, temperature=0.9)
    rg = g.serve(params, reqs,
                 generator=torch.Generator(device="cuda").manual_seed(3))
    re_ = e.serve(params, reqs,
                  generator=torch.Generator(device="cuda").manual_seed(3))
    assert [r.tokens for r in rg] == [r.tokens for r in re_]
    assert g.reports == e.reports
    assert len(g._graphs) == 1 and g.replays > 0
    again = g.serve(params, reqs,
                    generator=torch.Generator(device="cuda").manual_seed(4))
    assert [r.tokens for r in again] != [r.tokens for r in rg]


@pytest.mark.gpu
def test_graph_generate_and_decode_window_match_eager(cuda):
    """`generate` (aligned windows replay the "window" program, the last
    short one runs the generic loop) and an aligned `decode_window` after
    it, graph against eager: identical tokens, logits, reports and state;
    a replay's outputs are the caller's own (cloned), not the graph's."""
    _, params, g, e = _graph_pair(overlap=True)
    prompts = np.random.default_rng(3).integers(0, 256, (2, 5))
    for srv in (g, e):
        srv.reset()
    out_g, out_e = (s.generate(params, prompts, max_new=13) for s in (g, e))
    assert torch.equal(out_g, out_e)
    assert g.reports == e.reports
    toks = np.random.default_rng(4).integers(0, 256, (2, 8))
    g.reset()
    e.reset()
    lg1, sg1, _ = g.decode_window(params, toks)
    lg2, sg2, rg = g.decode_window(params, toks)   # a replay
    le1, se1, _ = e.decode_window(params, toks)
    le2, se2, re_ = e.decode_window(params, toks)
    for a, b in ((lg1, le1), (lg2, le2), (sg1, se1), (sg2, se2)):
        assert torch.equal(a, b)
    assert not torch.equal(lg1, lg2)
    from repro_torch.core import engine as eng
    assert eng.window_reports(rg) == eng.window_reports(re_)
    fg, fe = _flat(g.state), _flat(e.state)
    assert all(torch.equal(fg[k], fe[k]) for k in fg)
    assert {k[0] for k in g._graphs} == {"window"}


@pytest.mark.gpu
def test_graph_capture_failure_raises(cuda, monkeypatch):
    """A window that reads the device on the host cannot be captured: the
    serve raises, and nothing runs it eagerly instead."""
    from repro_torch.core import pool as pl
    _, params, g, _ = _graph_pair()
    rss = pl.rss_bytes

    def host_read(cfg, state):
        out = rss(cfg, state)
        float(out)                       # a device-to-host read
        return out
    monkeypatch.setattr(pl, "rss_bytes", host_read)
    with pytest.raises(RuntimeError):
        g.serve(params, _graph_requests(0))
    assert not g._graphs


@pytest.mark.gpu
def test_graph_follows_params(cuda):
    """The graphs are keyed by what they read of `params`: a weight updated
    in place replays the same graph, which reads its new values; a weight
    replaced in the dict captures anew and drops the old graph. Every
    serve matches the eager server given the same params, bit for bit."""
    import dataclasses
    _, params, g, e = _graph_pair()
    reqs = _graph_requests(7)

    def serve_both():
        rg, re_ = g.serve(params, reqs), e.serve(params, reqs)
        assert [dataclasses.asdict(r) for r in rg] == \
            [dataclasses.asdict(r) for r in re_]
        assert g.reports == e.reports and g.replays > 0
        fg, fe = _flat(g.state), _flat(e.state)
        assert all(torch.equal(fg[k], fe[k]) for k in fg)
        return [r.tokens for r in rg]

    first = serve_both()
    keys = set(g._graphs)
    # the final norm's multiplier is 1 + scale (zero at init): -1, then 1
    params["final_ln"].sub_(2.0)                   # in place: same graph
    flipped = serve_both()
    assert flipped != first and set(g._graphs) == keys
    params["final_ln"] = params["final_ln"] + 2.0  # a new tensor
    assert serve_both() == first
    assert len(g._graphs) == 1 and set(g._graphs).isdisjoint(keys)


# ---------------------------------------------------------------------------
# the MoE block (olmoe-1b-7b, mixtral-8x7b) on the card
# ---------------------------------------------------------------------------
def _moe_inputs(arch, dtype, b, s, seed, bias=0.0):
    """(cfg, params, x) on the CPU: weights from a seeded generator, x from
    numpy, pushed `bias` along expert seed % E's router column so that
    routing concentrates (and drops tokens at B=4 x S=64)."""
    import dataclasses
    from repro_torch.configs import get_config
    from repro_torch.models import moe
    cfg = dataclasses.replace(get_config(arch, reduced=True),
                              dtype=str(dtype)[6:])
    p = moe.init_moe(cfg, dtype, torch.Generator().manual_seed(0), "cpu")
    x = np.random.default_rng(seed).normal(size=(b, s, cfg.d_model))
    col = p["router"][:, seed % cfg.num_experts].numpy()
    x = x + bias * col / np.linalg.norm(col) * np.sqrt(cfg.d_model)
    return cfg, p, torch.from_numpy(x.astype(np.float32)).to(dtype)


def _drop_case(cfg, counts, t):
    """(tokens dropped, whether the drop bin row n holds a kept slot)."""
    from repro_torch.models import moe
    g, n = moe.capacity(t, cfg), t * cfg.experts_per_token
    cnt = counts.cpu().numpy()
    return int(np.maximum(cnt - g, 0).sum()), bool(cnt[n // g] > n % g)


# (arch, b, s, seed, bias): no drops, and drops with row n kept
MOE_GPU_CASES = [("olmoe-1b-7b", 2, 8, 1, 0.0), ("mixtral-8x7b", 2, 8, 1, 0.0),
                 ("olmoe-1b-7b", 4, 64, 5, 0.1),
                 ("mixtral-8x7b", 4, 64, 3, 0.1)]


@pytest.mark.gpu
@pytest.mark.parametrize("arch,b,s,seed,bias", MOE_GPU_CASES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_moe_block_on_card_matches_cpu(cuda, monkeypatch, arch, b, s, seed,
                                       bias, dtype):
    """`moe_block` on the card against the CPU on the same inputs: counts
    and aux loss equal (fp32 within 1e-6), outputs within 1e-5 in fp32
    (TF32 off) and within two bf16 ulps of the largest output in bf16; two
    runs on the card bit for bit; the drop cases drop with row n kept."""
    from repro_torch.models import moe
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", False)
    cfg, p, x = _moe_inputs(arch, dtype, b, s, seed, bias)
    oc, ac, cc = moe.moe_block(p, x, cfg)
    pg = _to(p, cuda)
    og, ag, cg = moe.moe_block(pg, x.to(cuda), cfg)
    og2, ag2, cg2 = moe.moe_block(pg, x.to(cuda), cfg)
    assert torch.equal(og, og2) and torch.equal(ag, ag2) and \
        torch.equal(cg, cg2)
    assert torch.equal(cc, cg.cpu())
    assert abs(float(ac) - float(ag)) < 1e-6
    err = (oc.float() - og.cpu().float()).abs().max().item()
    tol = 1e-5 if dtype == torch.float32 else \
        2 ** -6 * oc.float().abs().max().item()
    assert err < tol, (err, tol)
    drops, kept_n = _drop_case(cfg, cc, b * s)
    if bias:
        assert drops > 0 and kept_n, (drops, kept_n)
    else:
        assert drops == 0


@pytest.mark.gpu
@pytest.mark.parametrize("arch", ["olmoe-1b-7b", "mixtral-8x7b"])
def test_moe_block_cuda_graph_replays_bit_for_bit(cuda, arch):
    """`moe_block` (the drop case) captured in a CUDA graph: the capture
    holds no host sync, and each replay on new inputs gives the eager
    call's outputs bit for bit."""
    from repro_torch.models import moe
    cfg, p, x = _moe_inputs(arch, torch.bfloat16, 4, 64, 5, 0.1)
    pg, xg = _to(p, cuda), x.to(cuda)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        moe.moe_block(pg, xg, cfg)                 # warm up on the stream
    torch.cuda.current_stream().wait_stream(side)
    static_x = xg.clone()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=side):
        outs = moe.moe_block(pg, static_x, cfg)
    for seed in (5, 6):
        new = _moe_inputs(arch, torch.bfloat16, 4, 64, seed, 0.1)[2]
        static_x.copy_(new.to(cuda))
        graph.replay()
        want = moe.moe_block(pg, new.to(cuda), cfg)
        for a, b in zip(outs, want):
            assert torch.equal(a, b)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_moe_graph_serve_matches_eager(cuda, dtype):
    """olmoe-1b-7b reduced: two serve calls, each window after the first a
    graph replay, against the same calls op by op: identical Completions,
    reports, every leaf of the state bit for bit, and the same kernel
    launches (one paged_attention per layer and step)."""
    import dataclasses
    model, params, g, e = _graph_pair(dtype=dtype, arch="olmoe-1b-7b",
                                      overlap=dtype == "bfloat16")
    for call in range(2):
        reqs = _graph_requests(call)
        rg, cg = _counted(lambda: g.serve(params, reqs))
        re_, ce = _counted(lambda: e.serve(params, reqs))
        assert [dataclasses.asdict(r) for r in rg] == \
            [dataclasses.asdict(r) for r in re_], call
        assert g.reports == e.reports and g.serve_log == e.serve_log
        assert cg == ce, (cg, ce)
        steps = len(g.serve_log) * g.cfg.window
        assert cg["launches"]["paged_attention"] == \
            steps * model.cfg.num_layers
        fg, fe = _flat(g.state), _flat(e.state)
        for k in fg:
            assert torch.equal(fg[k], fe[k]), (call, k)
        assert g.replays > 0 and g.kv_rss_bytes() == 0.0


# ---------------------------------------------------------------------------
# the object engine on the card: one graph replay per aligned window
# ---------------------------------------------------------------------------
def _engine(pcfg, backend, every, overlap, dev, eager=False):
    from repro_torch.core import backend as be
    from repro_torch.core import engine as eng
    p = (dict(hbm_high_bytes=2 * pcfg.sb_bytes, hbm_low_bytes=pcfg.sb_bytes)
         if backend == "promote" else be.pressure_params(backend,
                                                         2 * pcfg.sb_bytes))
    e = eng.Engine(pcfg, eng.EngineOptions(
        collect_every=every, backend=be.make(backend, **p),
        overlap_collect=overlap), device=dev)
    e._run.eager = eager
    return e


def _loaded(e, n, rng):
    """A fresh pool with objects 0..n-1 allocated, and their payloads."""
    vals = rng.normal(size=(n, e.cfg.slot_words)).astype(np.float32)
    state, _, _ = e.step(e.init(), "alloc", np.arange(n), vals)
    return state


def _engine_windows(rng, n_objs, k, every, n_windows, w):
    """Windows of `every` steps over ids < n_objs, two op patterns in turn
    (so that each repeats): random reads and frees (ids repeat), writes and
    allocs of distinct ids (the last of several writes to one slot is not
    defined on the card)."""
    kinds = ["read", "read", "write", "free", "alloc"]
    patterns = [[kinds[i % 5] for i in rng.permutation(every) + j]
                for j in range(2)]
    steps = []
    for i in range(n_windows):
        for kind in patterns[i % 2]:
            if kind in ("write", "alloc"):
                steps.append((kind, rng.choice(n_objs, k, replace=False),
                              rng.normal(size=(k, w)).astype(np.float32)))
            else:
                steps.append((kind, rng.integers(0, n_objs, k), None))
    return steps


def _engine_pair_run(pcfg, backend, every, overlap, steps, n_load, cuda,
                     calls=2):
    """The same loaded pool and windows through a graph engine and an
    eager one on the card (the trace in `calls` aligned calls). Returns
    the two (state, outs, reports, launch counts) and the graph engine."""
    import torch.utils._pytree as pytree
    from repro_torch.core import engine as eng
    runs = []
    for eager in (False, True):
        e = _engine(pcfg, backend, every, overlap, cuda, eager)
        state = _loaded(e, n_load, np.random.default_rng(1))
        trace = eng.make_trace(pcfg, steps, device=cuda)
        t = len(steps)
        cut = (t // every // calls) * every
        outs, reps = [], []
        ptr = state["data"].untyped_storage().data_ptr()

        def go(state=state):
            for lo, hi in ((0, cut), (cut, t)):
                chunk = {k: v[lo:hi] for k, v in trace.items()}
                state, out, rep = e.run_window(state, chunk, lo)
                outs.append(out)
                reps.append(rep)
            return state
        state, counts = _counted(go)
        assert state["data"].untyped_storage().data_ptr() == ptr
        rep = {k: torch.cat([r[k] for r in reps]) for k in reps[0]}
        runs.append((state, torch.cat(outs), rep, counts, e))
    return runs


@pytest.mark.gpu
@pytest.mark.parametrize("overlap", [False, True])
@pytest.mark.parametrize("every", [1, 4])
@pytest.mark.parametrize("backend", BACKENDS)
def test_engine_graph_matches_eager(cuda, backend, every, overlap):
    """`Engine.run_window` at test_engine.py's pool: each aligned window
    after the first of its op pattern one graph replay, against the same
    windows op by op: every leaf of the state, the read outputs, the
    per-step reports and the kernel launches (counted through the replays)
    identical; the pool's `data` never leaves its storage."""
    from repro_torch.core import pool as pl
    pcfg = pl.make_config(64, 8, sb_slots=8, page_slots=4, slack=2.0)
    steps = _engine_windows(np.random.default_rng(every), 48, 6, every,
                            16 // every, 8)
    (sg, og, rg, cg, eg), (se, oe, re_, ce, ee) = _engine_pair_run(
        pcfg, backend, every, overlap, steps, 48, cuda)
    fg, fe = _flat(sg), _flat(se)
    assert sorted(fg) == sorted(fe)
    for k in fg:
        assert torch.equal(fg[k], fe[k]), k
    assert torch.equal(og, oe)
    for k in rg:
        assert torch.equal(rg[k], re_[k]), k
    assert cg == ce and cg["launches"]["access_scan"] == 16 // every
    assert cg["launches"]["migrate"] == 16 // every
    assert eg.replays == 16 // every - len(eg._run._g.graphs) > 0
    assert ee.replays == 0 and ee._run._g is None


@pytest.mark.gpu
def test_engine_unaligned_window_runs_op_by_op(cuda):
    """A call from an unaligned clock, or of an unaligned length, captures
    nothing and replays nothing; it equals the eager engine's."""
    from repro_torch.core import engine as eng
    from repro_torch.core import pool as pl
    pcfg = pl.make_config(64, 8, sb_slots=8, page_slots=4, slack=2.0)
    steps = _engine_windows(np.random.default_rng(5), 48, 6, 4, 3, 8)
    out = []
    for eager in (False, True):
        e = _engine(pcfg, "mglru", 4, True, cuda, eager)
        state = _loaded(e, 48, np.random.default_rng(1))
        trace = eng.make_trace(pcfg, steps, device=cuda)
        state, o1, r1 = e.run_window(state, {k: v[:6] for k, v in
                                             trace.items()}, 2)
        state, o2, r2 = e.run_window(state, {k: v[6:] for k, v in
                                             trace.items()}, 8)
        assert e.replays == 0 and e._run._g is None
        out.append((state, o1, o2, eng.window_reports(r1),
                    eng.window_reports(r2)))
    (sa, *rest_a), (sb, *rest_b) = out
    assert all(torch.equal(a, b) for a, b in zip(rest_a[:2], rest_b[:2]))
    assert rest_a[2:] == rest_b[2:]
    fa, fb = _flat(sa), _flat(sb)
    assert all(torch.equal(fa[k], fb[k]) for k in fa)


POOL_2_16 = (65536, 64)      # objects, words per slot (fp32)


@pytest.mark.gpu
def test_engine_at_2_16_objects_graph_eager_cpu(cuda):
    """A pool of 2^16 objects (98304 slots, 256 B rows), windows of 8
    steps of 1024 ids: graph against eager on the card bit for bit, and
    the card against the CPU (plain versions of both kernels)."""
    from repro_torch.core import engine as eng
    from repro_torch.core import pool as pl
    n, w = POOL_2_16
    pcfg = pl.make_config(n, w, sb_slots=64, page_slots=4, slack=1.5)
    steps = _engine_windows(np.random.default_rng(7), n, 1024, 8, 6, w)
    (sg, og, rg, cg, eg), (se, oe, re_, ce, _) = _engine_pair_run(
        pcfg, "proactive", 8, False, steps, n, cuda)
    fg, fe = _flat(sg), _flat(se)
    assert all(torch.equal(fg[k], fe[k]) for k in fg)
    assert torch.equal(og, oe) and cg == ce and eg.replays == 4
    assert all(torch.equal(rg[k], re_[k]) for k in rg)
    moved = rg["moved_to_hot"].sum() + rg["moved_to_cold"].sum()
    assert moved > 0
    e = _engine(pcfg, "proactive", 8, False, "cpu")
    state = _loaded(e, n, np.random.default_rng(1))
    state, oc, rc = e.run_window(state, eng.make_trace(pcfg, steps,
                                                      device="cpu"), 0)
    fc = _flat(state)
    assert all(torch.equal(fc[k], fg[k].cpu()) for k in fc)
    assert torch.equal(oc, og.cpu())
    assert all(torch.equal(rc[k], rg[k].cpu()) for k in rc)


@pytest.mark.gpu
def test_engine_kernel_path_matches_plain(cuda, monkeypatch):
    """The graph engine (access_scan and migrate kernels) against the same
    windows op by op with both kernels' plain versions patched in, at the
    2^16-object pool: every leaf identical."""
    from repro_torch.core import engine as eng
    from repro_torch.core import pool as pl
    n, w = POOL_2_16
    pcfg = pl.make_config(n, w, sb_slots=64, page_slots=4, slack=1.5)
    steps = _engine_windows(np.random.default_rng(8), n, 1024, 8, 4, w)
    states = []
    for plain in (False, True):
        if plain:
            monkeypatch.setattr(tops, "access_scan", tref.access_scan)
            monkeypatch.setattr(tops, "migrate", tref.migrate)
        e = _engine(pcfg, "reactive", 8, True, cuda, eager=plain)
        state = _loaded(e, n, np.random.default_rng(1))
        tops.reset_launches()
        state, _, _ = e.run_window(
            state, eng.make_trace(pcfg, steps, device=cuda), 0)
        torch.cuda.synchronize()
        want = 0 if plain else 4
        assert tops.launches["access_scan"] == tops.launches["migrate"] \
            == want
        states.append(_flat(state))
    assert all(torch.equal(states[0][k], states[1][k]) for k in states[0])


@pytest.mark.gpu
@pytest.mark.parametrize("backend", BACKENDS)
def test_simheap_backend_on_card_matches_cpu(cuda, backend):
    """SimHeap with its backend stepping on the card against the CPU: the
    window logs and page arrays identical over a pressured run."""
    from repro_torch.core.simheap import SimConfig, SimHeap
    cfg = SimConfig(max_objects=2048, heap_bytes=1 << 23, backend=backend,
                    hbm_target_bytes=1 << 18)
    heaps = [SimHeap(cfg, seed=0, device=d) for d in (cuda, "cpu")]
    for h in heaps:
        rng = np.random.default_rng(0)
        h.alloc(np.arange(2048), rng.integers(64, 2048, 2048))
        for _ in range(10):
            h.access_objects(rng.integers(0, 256, 512))
            h.collect()
            h.backend_step()
    g, c = heaps
    assert g.window_log == c.window_log
    for k in ("addr", "heap", "resident", "evict", "referenced"):
        assert np.array_equal(getattr(g, k), getattr(c, k)), k
    if backend not in ("null", "proactive"):
        assert (g.evict == 2).any()


@pytest.mark.gpu
def test_hades_on_card_matches_cpu(cuda):
    """The quickstart's Hades run on the card and on the CPU: identical
    reads, state, reports and metrics."""
    from repro_torch.core import Hades, HadesOptions
    from repro_torch.core import backend as be
    from repro_torch.core import pool as pl
    pcfg = pl.make_config(512, 32, sb_slots=16, page_slots=4, slack=2.0)
    vals = np.arange(512 * 32, dtype=np.float32).reshape(512, 32)
    res = []
    for dev in (cuda, "cpu"):
        h = Hades(pcfg, HadesOptions(collect_every=4,
                                     backend=be.make("proactive")),
                  device=dev)
        h.alloc(np.arange(512), vals)
        h.end_load_phase()
        rng = np.random.default_rng(0)
        hot = rng.permutation(512)[:48]
        outs = [h.read(hot[rng.integers(0, 48, size=16)]).cpu()
                for _ in range(96)]
        back = h.read(np.arange(512)).cpu()
        res.append((outs, back, _flat({k: v for k, v in h.state.items()}),
                    h.heap_histogram(), h.counters(), h.rss_bytes()))
    (og, bg, sg, *mg), (oc, bc, sc, *mc) = res
    assert all(torch.equal(a, b) for a, b in zip(og, oc))
    assert torch.equal(bg, bc) and torch.equal(bc, torch.from_numpy(vals))
    assert all(torch.equal(sg[k].cpu(), sc[k]) for k in sc)
    assert mg == mc and mc[1]["moves"] > 0


CREST_ARRAYS = ("addr", "size", "heap", "access", "ciw", "atc", "resident",
                "referenced", "evict")


def _crest_pair(structure, workload, n, cuda, **sim):
    """The same CrestKV run with the SimHeap's backend on the card and on
    the CPU: [(kv, stats)] * 2."""
    from repro_torch.data.crestkv import CrestKV, default_sim_config
    out = []
    for dev in (cuda, "cpu"):
        kv = CrestKV(structure, n, default_sim_config(n, **sim), seed=0,
                     device=dev)
        out.append((kv, kv.run(workload, 12 * n, window_ops=3 * n, seed=1)))
    return out


def _assert_crest_equal(a, b):
    (ka, sa), (kb, sb) = a, b
    assert sa == sb and ka.heap.window_log == kb.heap.window_log
    assert np.array_equal(ka.value_obj, kb.value_obj)
    for k in CREST_ARRAYS:
        assert np.array_equal(getattr(ka.heap, k), getattr(kb.heap, k)), k
    for k in ("cursor", "live_bytes", "total_moves", "ciw_threshold"):
        assert getattr(ka.heap, k) == getattr(kb.heap, k), k


@pytest.mark.gpu
@pytest.mark.parametrize("structure", sorted(STRUCTURES))
def test_crestkv_structure_on_card_matches_cpu(cuda, structure):
    """Table 1's run (YCSB-A, HADES with `proactive`) at 2,000 keys: the
    backend on the card gives the CPU's run exactly."""
    _assert_crest_equal(*_crest_pair(structure, "A", 2000, cuda,
                                     backend="proactive", enabled=True))


@pytest.mark.gpu
@pytest.mark.parametrize("backend", BACKENDS)
def test_crestkv_backend_on_card_matches_cpu(cuda, backend):
    """hash-pugh under YCSB-B with each backend under a memory target:
    the card's run is the CPU's exactly."""
    pair = _crest_pair("hash-pugh", "B", 2000, cuda, backend=backend,
                       enabled=True, hbm_target_bytes=int(0.4 * 2000 * 1200))
    _assert_crest_equal(*pair)
    if backend in ("cap", "reactive", "mglru"):
        assert pair[0][1].faults > 0


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_embedding_on_card_matches_cpu(cuda, dtype):
    """Windows of lookup and collect, then write_rows, at vocab 1024 x 32
    with 64 hot rows: every output, report and state leaf on the card
    equals the CPU's."""
    from repro_torch.models import embedding as emb
    cfg = emb.TieredEmbeddingConfig(vocab_size=1024, d_model=32, hot_rows=64)
    table = torch.randn(1024, 32, generator=torch.Generator().manual_seed(0))
    w = 1.0 / np.power(np.arange(1, 1025, dtype=np.float64), 1.1)
    cdf = np.cumsum(w) / np.sum(w)
    rng = np.random.default_rng(0)
    toks = [torch.from_numpy(rng.permutation(1024)[np.searchsorted(
        cdf, rng.random((4, 256)))].astype(np.int32)) for _ in range(6)]
    rows = torch.from_numpy(rng.permutation(1024)[:16])
    vals = torch.randn(16, 32, generator=torch.Generator().manual_seed(1))
    res = []
    for dev in (cuda, "cpu"):
        s = emb.init(cfg, table.to(dev, dtype))
        outs = []
        for t in toks:
            e, s = emb.lookup(cfg, s, t.to(dev))
            s, rep = emb.collect(cfg, s)
            outs += [e, *rep.values(), *s.values()]
        s = emb.write_rows(s, rows.to(dev), vals.to(dev, dtype))
        res.append([o.cpu() for o in outs + list(s.values())])
    assert all(torch.equal(a, b) for a, b in zip(*res))


# --- the distributed layer (`launch/`, `optim/compression.py`) ----------

@pytest.mark.gpu
@pytest.mark.parametrize("shape", [(1000,), (64, 256), (3, 7, 129)])
def test_compression_on_card_matches_cpu(cuda, shape):
    """compress_int8 / decompress_int8 on the card: q, the scales and the
    values equal the CPU's bit for bit (one all-zero block)."""
    from repro_torch.optim import compression as comp
    g = torch.from_numpy(np.random.default_rng(3).standard_normal(
        shape).astype(np.float32))
    if shape == (64, 256):
        g[5] = 0.0
    q, s = comp.compress_int8(g)
    qd, sd = comp.compress_int8(g.to(cuda))
    assert torch.equal(q, qd.cpu()) and torch.equal(s, sd.cpu())
    assert torch.equal(comp.decompress_int8(q, s, shape, torch.float32),
                       comp.decompress_int8(qd, sd, shape,
                                            torch.float32).cpu())


@pytest.fixture
def nccl_mesh(cuda):
    """The (1, 1) host mesh over a world-1 NCCL group on the card (tcp on
    localhost), destroyed after the test."""
    import socket
    import torch.distributed as dist
    from repro_torch.launch.mesh import make_host_mesh
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    dist.init_process_group("nccl", init_method=f"tcp://127.0.0.1:{port}",
                            rank=0, world_size=1, device_id=torch.device(
                                "cuda", torch.cuda.current_device()))
    try:
        yield make_host_mesh(device_type="cuda")
    finally:
        dist.destroy_process_group()


@pytest.mark.gpu
def test_world1_nccl_mesh_prefill_matches_plain(nccl_mesh):
    """A reduced qwen2-vl in fp32 on the card: the prefill of DTensor
    params and inputs laid out by the sharding rules on the (1, 1) NCCL
    mesh equals the plain-tensor prefill bit for bit; compressed_allreduce
    over the mesh's data axis returns the local decompression."""
    import dataclasses
    from torch.distributed.tensor.experimental import implicit_replication
    from repro_torch.configs import get_config
    from repro_torch.launch import shardings as sh
    from repro_torch.models.model import Model
    from repro_torch.optim import compression as comp
    dev = torch.device("cuda")
    cfg = dataclasses.replace(get_config("qwen2-vl-72b", reduced=True),
                              dtype="float32")
    model = Model(cfg, device="cuda")
    params = model.init(torch.Generator(device=dev).manual_seed(0))
    g = torch.Generator(device=dev).manual_seed(1)
    batch = {"tokens": torch.randint(0, cfg.vocab_size, (2, 24),
                                     generator=g, device=dev),
             "extra_embeds": torch.randn(2, 8, cfg.d_model, generator=g,
                                         device=dev) * 0.02}
    plain = model.prefill(params, batch)
    dp = sh.distribute(params, nccl_mesh, sh.param_shardings(
        nccl_mesh, params), src_data_rank=None)
    db = sh.distribute(batch, nccl_mesh, sh.batch_shardings(
        nccl_mesh, batch), src_data_rank=None)
    with implicit_replication():
        out = model.prefill(dp, db)
    assert torch.equal(out.full_tensor(), plain)
    grads = {"w": torch.randn(3, 300, generator=g, device=dev)}
    red, err = comp.compressed_allreduce(grads, (nccl_mesh, "data"))
    local = comp.decompress_int8(*comp.compress_int8(grads["w"]), (3, 300),
                                 torch.float32)
    assert torch.equal(red["w"], local)
    assert torch.equal(err["w"], grads["w"] - local)


@pytest.mark.gpu
def test_world1_nccl_mesh_flash_prefill_matches_plain(nccl_mesh):
    """A reduced qwen2-vl in bf16 with attn_impl "flash" on the card: the
    prefill of DTensor params and inputs on the (1, 1) NCCL mesh, where
    the kernel runs on the local tensors, launches it once a layer on the
    tensor cores and equals the plain-tensor prefill bit for bit."""
    from torch.distributed.tensor.experimental import implicit_replication
    from repro_torch.configs import get_config
    from repro_torch.launch import shardings as sh
    from repro_torch.models.model import Model
    dev = torch.device("cuda")
    cfg = get_config("qwen2-vl-72b", reduced=True)
    model = Model(cfg, attn_impl="flash", device="cuda")
    params = model.init(torch.Generator(device=dev).manual_seed(0))
    g = torch.Generator(device=dev).manual_seed(1)
    batch = {"tokens": torch.randint(0, cfg.vocab_size, (2, 24),
                                     generator=g, device=dev),
             "extra_embeds": torch.randn(2, 8, cfg.d_model, generator=g,
                                         device=dev) * 0.02}
    plain = model.prefill(params, batch)
    dp = sh.distribute(params, nccl_mesh, sh.param_shardings(
        nccl_mesh, params), src_data_rank=None)
    db = sh.distribute(batch, nccl_mesh, sh.batch_shardings(
        nccl_mesh, batch), src_data_rank=None)
    snap = tops.count_snapshot()
    with implicit_replication():
        out = model.prefill(dp, db)
    got = tops.counts_since(snap)
    assert got["launches"]["flash_attention"] == cfg.num_layers
    assert got["flash_variants"][tops.TENSOR_CORES] == cfg.num_layers
    assert torch.equal(out.full_tensor(), plain)
