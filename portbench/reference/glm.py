"""A plain fp32 forward of the GLM dense decoder as the benchmark serves
it (chatglm3-6b: GQA, ChatGLM's partial rotary, RMSNorm, SwiGLU), over
whole sequences, for judging served tokens. Plain torch only: it imports
no kernel and nothing of the port.

The model follows the published description with the port's choices,
which are the configuration as run: no qkv bias (the published config has
`add_qkv_bias`), RMSNorm with a zero-centred scale (x * (1 + scale)), the
rotary on the first half of each head as two contiguous halves (ChatGLM
interleaves pairs), weights laid out [in, out].

`logits(...)` runs layer by layer over a list of sequences, each layer's
weights cast to fp32 once, so that a 28-layer model at full width fits
beside nothing else. TF32 is switched off for its products. With `fp8`
every matrix product instead takes its two operands rounded to float8
e4m3 (the weight with one scale per tensor, the activation with one per
row): the control, the precision a later change could be tempted to
serve in.
"""
from __future__ import annotations

from typing import Dict, List, Sequence

import torch

FP8_MAX = 448.0


def _q8(x: torch.Tensor, dim=None) -> torch.Tensor:
    """x rounded to float8 e4m3 under an amax scale (per tensor, or per
    slice along `dim`), back in fp32."""
    amax = x.abs().amax() if dim is None else x.abs().amax(dim, keepdim=True)
    scale = torch.clamp(amax, min=1e-12) / FP8_MAX
    return (x / scale).to(torch.float8_e4m3fn).to(torch.float32) * scale


def _mm(x: torch.Tensor, w: torch.Tensor, fp8: bool) -> torch.Tensor:
    if fp8:
        return _q8(x, dim=-1) @ _q8(w)
    return x @ w


def _rms(x, scale, eps):
    return x * torch.rsqrt(x.square().mean(-1, keepdim=True) + eps) * \
        (1.0 + scale)


def _rope2d(x: torch.Tensor, theta: float) -> torch.Tensor:
    """x [S, H, D]: rotate the first D/2 lanes by position, as two halves."""
    s, _, d = x.shape
    half = d // 2
    inv = 1.0 / theta ** (torch.arange(0, half, 2, dtype=torch.float32,
                                       device=x.device) / half)
    ang = torch.arange(s, dtype=torch.float32, device=x.device)[:, None] * inv
    cos, sin = torch.cos(ang)[:, None], torch.sin(ang)[:, None]
    x1, x2 = x[..., :half].chunk(2, dim=-1)
    return torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos,
                      x[..., half:]], dim=-1)


def _attention(q, k, v, rep: int) -> torch.Tensor:
    """Causal softmax attention, q [S, H, D], k/v [S, KV, D], fp32."""
    s, h, d = q.shape
    k = k.repeat_interleave(rep, dim=1)
    v = v.repeat_interleave(rep, dim=1)
    scores = torch.einsum("qhd,khd->hqk", q * d ** -0.5, k)
    mask = torch.ones(s, s, dtype=torch.bool, device=q.device).tril()
    scores = scores.masked_fill(~mask, float("-inf"))
    return torch.einsum("hqk,khd->qhd", torch.softmax(scores, -1), v)


def _layer(p: Dict[str, torch.Tensor], x: torch.Tensor, sizes: Dict,
           fp8: bool) -> torch.Tensor:
    s = x.shape[0]
    h, kv, d = sizes["num_heads"], sizes["num_kv_heads"], sizes["head_dim"]
    theta, eps = sizes["rope_theta"], sizes["norm_eps"]
    a = _rms(x, p["ln1"], eps)
    q = _rope2d(_mm(a, p["wq"], fp8).view(s, h, d), theta)
    k = _rope2d(_mm(a, p["wk"], fp8).view(s, kv, d), theta)
    v = _mm(a, p["wv"], fp8).view(s, kv, d)
    x = x + _mm(_attention(q, k, v, h // kv).reshape(s, h * d), p["wo"], fp8)
    f = _rms(x, p["ln2"], eps)
    g = torch.nn.functional.silu(_mm(f, p["wg"], fp8)) * _mm(f, p["wi"], fp8)
    return x + _mm(g, p["wo_ff"], fp8)


def _fp32(t: torch.Tensor, device) -> torch.Tensor:
    return t.to(device=device, dtype=torch.float32)


def logits(weights: Dict, sizes: Dict, seqs: Sequence[torch.Tensor], *,
           fp8: bool = False, device=None) -> List[torch.Tensor]:
    """Logits [len(s), vocab] fp32 of each token sequence in `seqs` (int64
    tensors). `weights`: {"embed" [V, D], "final_ln" [D], "out" [D, V],
    "layers": [{"ln1", "ln2", "wq", "wk", "wv", "wo", "wi", "wg",
    "wo_ff"}]}, in any dtype; each is cast to fp32 where it is used."""
    device = device or weights["embed"].device
    eps = sizes["norm_eps"]
    tf32 = (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        with torch.no_grad():
            xs = [_fp32(weights["embed"][s.to(weights["embed"].device)],
                        device) for s in seqs]
            for lp in weights["layers"]:
                p = {k: _fp32(v, device) for k, v in lp.items()}
                xs = [_layer(p, x, sizes, fp8) for x in xs]
                del p
            out = _fp32(weights["out"], device)
            fin = _fp32(weights["final_ln"], device)
            return [_mm(_rms(x, fin, eps), out, fp8) for x in xs]
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = tf32


def served_gaps(ref: torch.Tensor, prompt_len: int, served: Sequence[int]
                ) -> torch.Tensor:
    """For each served token i, how far its logit lies below the best of
    the reference's logits at the position that predicts it (p - 1 + i):
    ref [>= p - 1 + n, V] -> [n]."""
    rows = ref[prompt_len - 1:prompt_len - 1 + len(served)]
    tok = torch.as_tensor(list(served), dtype=torch.long, device=rows.device)
    return rows.max(-1).values - rows.gather(1, tok[:, None])[:, 0]
