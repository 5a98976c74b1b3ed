"""The port's hand-written Hopper kernels (CUDA C++ in `csrc/`, built by
`build.py`, wrapped by `ops.py`) and their plain PyTorch versions
(`ref.py`):

  paged_attention  decode through the object table, fused access bits
  access_scan      collector table sweep (CIW update, Fig. 5 masks)
  migrate          Object Collector data mover (gather, then scatter)
  flash_attention  full-sequence causal / sliding-window attention (prefill)
  mamba_scan       selective-SSM recurrence h_t = a_t h_{t-1} + b_t (mamba1)
"""
