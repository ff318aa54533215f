"""PyTorch/CUDA port of the diagonal-batching ARMT system.

The JAX package ``repro`` is the reference; this package mirrors its module
layout (``configs``, ``core``, ``models``, ``kernels``, ``serve``) and
imports nothing from it. Plain tensor code is PyTorch; the diagonal
prefill's hot spots and decode attention run on hand-written Hopper kernels
(``kernels/csrc/*.cu``), built at first use. Entry points run on the CUDA
device unless the caller passes ``device="cpu"``, where every kernel
wrapper takes its plain PyTorch version.
"""
