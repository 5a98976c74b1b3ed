"""The traffic generators and the metric arithmetic, on the CPU: every
mix repeats for a seed and keeps to its stated ranges, and each per-layer
reader and roofline count gives what a hand count gives on recorded
numbers."""
from pathlib import Path

import numpy as np
import pytest
import torch

from portbench import bench, gen, peaks, rooflines, serve_cell
from portbench.reference import schedule

HERE = Path(__file__).resolve().parent
CHAT = gen.load_mix("chat")
B_ZIPF = gen.load_mix("b-zipf")
BIG = 2 ** 31 + 977


def _reader(name):
    return bench.load_module(bench.reader_path(name)).read


def test_serve_sizes_are_the_mix_whatever_the_seed():
    sizes = gen.serve_sizes(CHAT)
    assert len(sizes) == CHAT["requests_per_call"]
    p, o = np.array(sizes).T
    # the source's means (LMSYS-Chat-1M), within the mix's clips
    assert p.mean() == pytest.approx(69.5, abs=0.1)
    assert o.mean() == pytest.approx(214.5, abs=0.1)
    assert p.min() >= 4 and p.max() <= 384
    assert o.min() >= 8 and o.max() <= 512
    assert (p + o).max() < 1024          # a request fits max_len
    orders = []
    for seed in (0, BIG):
        call = gen.serve_call(CHAT, seed, 0, 65024)
        assert sorted((len(a), n) for a, n in call) == sorted(sizes)
        assert all(0 <= a.min() and a.max() < 65024 for a, _ in call)
        orders.append([(len(a), n) for a, n in call])
    # every seed queues the same sizes in the same drawn order, which
    # nothing sorts
    assert orders[0] == orders[1]
    totals = [a + n for a, n in orders[0]]
    assert totals != sorted(totals, reverse=True)
    assert totals != sorted(totals)


def test_lengths_meet_a_mean_within_the_clips():
    spec = {"mean": 40.0, "sigma": 1.0, "min": 4, "max": 100}
    x = gen.lengths(64, spec)
    assert x.mean() == pytest.approx(40.0, abs=0.5)
    assert x.min() >= 4 and x.max() <= 100
    assert np.all(np.diff(x) >= 0)


@pytest.mark.parametrize("seed", [0, BIG])
def test_serve_calls_repeat_for_a_seed(seed):
    a = gen.serve_call(CHAT, seed, 1, 65024)
    b = gen.serve_call(CHAT, seed, 1, 65024)
    c = gen.serve_call(CHAT, seed + 1, 1, 65024)
    assert all(np.array_equal(x, y) and m == n
               for (x, m), (y, n) in zip(a, b))
    assert not all(np.array_equal(x, y) for (x, _), (y, _) in zip(a, c))


def test_ycsb_keys_repeat_and_are_skewed():
    mix = dict(B_ZIPF, ops_per_step=512)
    a, b = (torch.stack([s.window() for _ in range(3)])
            for s in (gen.YcsbKeys(mix, 10000, BIG, "cpu"),
                      gen.YcsbKeys(mix, 10000, BIG, "cpu")))
    assert a.shape == (3, 20, 512) and a.dtype == torch.int32
    assert torch.equal(a, b)
    assert 0 <= int(a.min()) and int(a.max()) < 10000
    counts = torch.bincount(a.flatten().long(), minlength=10000)
    top = counts.sort(descending=True).values
    assert top[:100].sum() > 0.25 * a.numel()       # θ = 0.99: skewed
    assert gen.ycsb_ops(B_ZIPF) == ["read"] * 19 + ["write"]


def test_payload_is_a_function_of_seed_key_window():
    keys = torch.tensor([5, 9, 5, 1 << 19], dtype=torch.int32)
    a = gen.payload(BIG, keys, 3, 256)
    assert a.dtype == torch.float32 and a.shape == (4, 256)
    assert torch.equal(a[0], a[2])
    assert torch.equal(a, gen.payload(BIG, keys, 3, 256))
    assert not torch.equal(a, gen.payload(BIG, keys, 4, 256))
    assert not torch.equal(a, gen.payload(BIG + 1, keys, 3, 256))
    assert float(a.min()) >= -1.0 and float(a.max()) < 1.0


def test_lane_model_counts_blocks():
    sizes = [(5, 4), (20, 3), (3, 2)]
    wins = schedule.windows(sizes, lanes=2, window=4, max_len=64)
    # lane 0: 8 steps (two windows), lane 1: 22 steps; request 2 takes lane
    # 0 at window 2; a final all-inactive window frees the last lane
    assert [len(w["running"]) for w in wins] == [2, 2, 2, 1, 1, 1, 0]
    assert wins[2]["running"][0] == (0, 2, 0)
    assert schedule.live_blocks(wins[0], 4, 4, 16, 3) == 3 * 2


def test_roofline_byte_counts():
    assert rooflines.paged_attention_bytes([3, 0, 5], 32, 2, 128, 2) == \
        2 * 8 * 2 * 128 * 2 + 2 * 2 * 32 * 128 * 2
    assert rooflines.access_scan_bytes(1000) == 10008
    assert rooflines.migrate_bytes(10, 1024, 512) == 2 * 10 * 1024 + 9 * 512
    assert peaks.bound_s(3.35e12) == 1.0
    assert peaks.bound_s(0, 989e12, "bf16") == 1.0
    assert peaks.share_pct(1.0, 4.0) == 25.0 and peaks.share_pct(1, 0) is None


def _serve_rec(profile=True):
    sizes = [(4, 3), (2, 5)]
    sched = schedule.windows(sizes, 2, 4, 64)
    stamps = [0.0, 0.1, 0.3, 0.4]
    calls = [{"sizes": sizes, "stamps": stamps,
              "serve_log": [{"active": 2}, {"active": 1}, {"active": 0}]}]
    reports = [{"moved_to_hot": 3, "moved_to_cold": 1},
               {"moved_to_hot": 0, "moved_to_cold": 4}]
    prof = {"at": 1, "windows": [1], "busy_s": 0.05, "window_s": 0.2,
            "running": [sched[1]["running"]], "moved": [4],
            "kernels": 12, "kernels_by_name": {
                "paged_attention_split_mma_kernel": (4, 2e-6),
                "paged_attention_combine_kernel": (4, 2e-6),
                "access_scan_kernel": (1, 1e-6),
                "migrate_kernel": (1, 4e-6)}} if profile else None
    sizes_m = dict(num_layers=1, hidden_size=8, ffn_hidden_size=16,
                   vocab=32, num_heads=2, num_kv_heads=1, head_dim=4)
    return {"calls": calls, "reports": reports, "schedules": [sched],
            "lanes": 2, "window": 4,
            "max_len": 64, "seconds": 0.4, "profile": prof,
            "sizes": sizes_m, "model_flops": serve_cell.model_flops,
            "n_objects": 100, "slot_bytes": 64, "move_budget": 8}


def test_serve_readers_on_recorded_numbers():
    rec = _serve_rec(profile=False)
    assert _reader("serve.lane_occupancy")(rec) == 3 / 6
    assert _reader("serve.ms_per_step")(rec) == pytest.approx(1e3 * 0.4 / 12)
    assert _reader("collector.rows_moved_per_window")(rec) == 4.0
    for name in ("serve.kernels_per_step", "paged_attention_roofline",
                 "device.idle_frac.serve", "migrate_roofline.serve"):
        assert _reader(name)(rec) is None
    # mfu: each request's p + n - 1 = 6 steps, at positions 0 to 5
    f = serve_cell.model_flops
    want = 2 * sum(f(rec["sizes"], j) for j in range(6))
    assert _reader("serve.mfu")(rec) == pytest.approx(
        100 * want / 0.4 / 989e12)


def test_serve_trace_readers_on_recorded_numbers():
    rec = _serve_rec()
    assert _reader("serve.kernels_per_step")(rec) == 12 / 4
    # busy and window from the one profiled stretch
    assert _reader("device.idle_frac.serve")(rec) == pytest.approx(0.75)
    running = rec["schedules"][0][1]["running"]
    total = sum(rooflines.paged_attention_bytes(
        [b + s + 1 for _, _, b in running], 2, 1, 4, 2) for s in range(4))
    assert _reader("paged_attention_roofline")(rec) == pytest.approx(
        100 * total / 3.35e12 / 4e-6)
    assert _reader("access_scan_roofline.serve")(rec) == pytest.approx(
        100 * 1008 / 3.35e12 / 1e-6)
    assert _reader("migrate_roofline.serve")(rec) == pytest.approx(
        100 * (2 * 4 * 64 + 9 * 16) / 3.35e12 / 4e-6)


def test_engine_readers_on_recorded_numbers():
    reps = [{"moved_to_hot": 10, "moved_to_cold": 2, "rss_bytes": 2048.0}
            for _ in range(4)]
    prof = {"windows": [11, 12], "busy_s": 0.01, "window_s": 0.03,
            "kernels": 40, "moved": [12, 12], "kernels_by_name": {
                "access_scan_kernel": (2, 2e-6), "migrate_kernel": (2, 3e-6)}}
    rec = {"reports": reps, "profile": prof, "n_objects": 16,
           "slot_bytes": 64, "move_budget": 4,
           "stamps": [0.0, 0.02, 0.04, 0.06, 0.08], "page_utilization": 0.5}
    assert _reader("collector.rows_moved_per_window")(rec) == 12
    assert _reader("engine.device_ms_per_window")(rec) == 5.0
    assert _reader("engine.kernels_per_window")(rec) == 20
    assert _reader("engine.page_utilization")(rec) == 0.5
    assert _reader("device.idle_frac.engine")(rec) == pytest.approx(
        1 - 0.01 / 0.03)
    assert _reader("access_scan_roofline.engine")(rec) == pytest.approx(
        100 * 2 * 168 / 3.35e12 / 2e-6)
    assert _reader("migrate_roofline.engine")(rec) == pytest.approx(
        100 * (2 * 24 * 64 + 9 * 16) / 3.35e12 / 3e-6)
