"""Hand-written Hopper kernels of the diagonal prefill and their plain
PyTorch versions.

  grouped_matmul   QKV / output / FFN projections of a group of layers,
                   fused bias + activation epilogue
  flash_attention  one causal GQA launch over N = group * batch
  armt_memory      ARMT associative read and delta-rule update

``ops`` holds the entry points the fused cell calls, ``ref`` the plain
versions, ``build`` compiles ``csrc/*.cu`` at first use.
"""
