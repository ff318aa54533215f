"""Hand-written Hopper kernels of the diagonal prefill and of decode, and
their plain PyTorch versions.

  grouped_matmul    QKV / output / FFN projections of a group of layers,
                    fused bias + activation epilogue; with a residual
                    epilogue and the ARMT update, the B == 1 cell's down
                    projection (grouped_matmul_armt_update)
  flash_attention   one causal GQA launch over N = group * batch
  armt_memory       ARMT associative read and delta-rule update
  decode_attention  one query token per row against the serve KV cache
  mamba_scan        the Mamba-1 selective scan of a row band, h on chip

``ops`` holds the entry points the model calls, ``ref`` the plain
versions, ``build`` compiles ``csrc/*.cu`` at first use; ``swap`` replaces
ops entry points inside a block, for checks on the card.
"""
