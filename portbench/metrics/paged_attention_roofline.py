"""paged_attention's share of its bound in the profiled windows: the bytes
of the keys and values each lane's sequence holds at each step (from the
plain lane model), the queries and outputs, at 3.35 TB/s, over the split
and combine kernels' device time."""
from portbench import peaks, rooflines


def read(rec):
    prof = rec["profile"]
    if prof is None:
        return None
    n, t = rooflines.device_time(prof, "paged_attention")
    if not n:
        return None
    s, w = rec["sizes"], rec["window"]
    total = 0.0
    for running in prof["running"]:
        for step in range(w):
            lens = [min(before + step + 1, rec["max_len"])
                    for _, _, before in running]
            total += s["num_layers"] * rooflines.paged_attention_bytes(
                lens, s["num_heads"], s["num_kv_heads"], s["head_dim"], 2)
    return peaks.share_pct(peaks.bound_s(total), t)
