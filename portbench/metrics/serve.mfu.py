"""The whole serve step's share of the H100's bf16 peak: the operations of
the tokens the measured calls' windows processed (each running lane's
forced prompt tokens and generated ones, by the plain lane model; 2 a
weight of every product and the attention's 4 * H * Dh a cached
position) over those windows' host time and 989 TFLOP/s."""
from portbench import peaks, tracing


def window_flops(rec, call: int, i: int) -> float:
    c = rec["calls"][call]
    f, sizes = rec["model_flops"], rec["sizes"]
    total = 0.0
    for _, rid, before in rec["schedules"][call][i]["running"]:
        p, n = c["sizes"][rid]
        last = min(p + n - 2, rec["max_len"] - 1)
        total += sum(f(sizes, j) for j in range(before,
                                                min(before + rec["window"],
                                                    last + 1)))
    return total


def read(rec):
    flops, secs = 0.0, 0.0
    for ci, c in enumerate(rec["calls"]):
        for i, w in tracing.window_walls(c["stamps"]):
            if i < len(rec["schedules"][ci]):
                flops += window_flops(rec, ci, i)
                secs += w
    if not secs:
        return None
    return 100.0 * flops / secs / peaks.PEAK_OPS_PER_S["bf16"]
