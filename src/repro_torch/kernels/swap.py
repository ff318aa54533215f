"""Replace entry points of ``kernels/ops.py`` for the length of a block.

For checks on the card only: a negative control (an entry point made
deliberately wrong must fail a check), and a second rounding of the same
math (every entry point on its plain PyTorch version, whatever the device)
to tell where a model input is so ill-conditioned that no two roundings
agree. The serving path never enters these blocks.
"""
from __future__ import annotations

import contextlib

from repro_torch.kernels import (armt_memory, decode_attention, flash_attention,
                                 grouped_matmul, mamba_scan, ops)

# each name the ops module calls a kernel wrapper by, and that wrapper's
# plain version
PLAIN = {"grouped_matmul": grouped_matmul.grouped_matmul_plain,
         "grouped_matmul_armt_update": grouped_matmul.grouped_matmul_armt_update_plain,
         "flash_attention": flash_attention.flash_attention_plain,
         "assoc_read": armt_memory.armt_read_plain,
         "assoc_update": armt_memory.armt_update_plain,
         "decode_attention": decode_attention.decode_attention_plain,
         "mamba_scan": mamba_scan.mamba_scan_plain}


@contextlib.contextmanager
def replaced(**entries):
    """Set names of the ops module (``assoc_read=...``) inside the block."""
    old = {k: getattr(ops, k) for k in entries}
    for k, v in entries.items():
        setattr(ops, k, v)
    try:
        yield
    finally:
        for k, v in old.items():
            setattr(ops, k, v)


def plain_versions():
    """Every kernel the ops module reaches on its plain version, on any
    device."""
    return replaced(**PLAIN)
