"""ARMT associative memory: read and delta-rule update (paper eqs. 3-6).

Replaces the Pallas kernels ``armt_read`` (repro/kernels/armt_memory.py:67)
and ``armt_update`` (repro/kernels/armt_memory.py:114). Layout: x
``[N,T,D]``, A ``[N,P,Dv]`` and z ``[N,P]`` in fp32, N = G*batch; the
projection weights are shared ``[D,E]`` or per group ``[G,D,E]`` (row
``n // batch``). CUDA source: ``csrc/armt_memory.cu``. Each wrapper first
runs its projections of the activations (q; k and v) on the grouped-matmul
kernel with an fp32 epilogue (``project_f32``), then the memory kernels
proper, the update's computing the beta logit itself. For bf16 activations
the read's phi A runs on the tensor cores as a three-term bf16 split: one
launch splits phi and A once each, and the grouped-matmul mainloop
multiplies the three terms and divides by phi . z in its epilogue (three
device launches with the projection; see the CUDA sources). One wrapper
call counts as one launch.

``armt_update`` writes new A'/z' buffers and never updates A/z in place:
its blocks read A while others write A'.

Both take their config from ``kernels/dispatch.py``: armt_read's
``block_n`` is its bf16 product's column tile on the GEMM mainloop (128,
256; 0 ``choose_bn``'s pick); armt_update has one config.

Under gradients both run through autograd Functions (``ArmtReadFn``,
``ArmtUpdateFn``): the kernels forward, and backwards in PyTorch ops
(``kernels/grad.py``), in fp32 from the operands.
"""
from __future__ import annotations

import sys

import torch

from repro_torch.kernels import build, dispatch, grad
from repro_torch.kernels.grad import needs_grad
from repro_torch.kernels.grouped_matmul import project_f32
from repro_torch.kernels.ref import armt_read_ref as armt_read_plain
from repro_torch.kernels.ref import armt_update_ref as armt_update_plain

read_launches = 0     # armt_read launches since the last reset
update_launches = 0   # armt_update launches since the last reset
build.count_launches(sys.modules[__name__], "read_launches", "update_launches")

_DTYPE = {torch.float32: 0, torch.bfloat16: 1}
MAX_D_MEM = 64        # the kernels keep q/k rows of d_mem floats on chip
MAX_MEM_TOKENS = 128  # armt_update keeps the M memory rows of one n on chip
MAX_NU = 3
PHI_CHUNK = 32        # armt_update's K chunk: its phi scratch rows pad to a multiple


def _weight_groups(w, N: int, D: int, name: str) -> int:
    """Batch size per weight group: N for a shared [D,E] weight, N // G for
    a per-group [G,D,E] one."""
    if w.dim() == 2:
        G = 1
    elif w.dim() == 3:
        G = w.shape[0]
    else:
        raise ValueError(f"{name}: weight of shape {tuple(w.shape)}")
    if w.shape[-2] != D or N % G:
        raise ValueError(f"{name}: weight {tuple(w.shape)} vs N={N}, D={D}")
    if not w.is_contiguous():
        raise ValueError(f"{name}: weights must be contiguous")
    return N // G


def _check_state(A, z, N: int, P: int, name: str):
    if A.dim() != 3 or A.shape[:2] != (N, P) or z.shape != (N, P):
        raise ValueError(f"{name}: A {tuple(A.shape)} z {tuple(z.shape)} vs "
                         f"N={N}, P={P}")
    if A.dtype != torch.float32 or z.dtype != torch.float32:
        raise ValueError(f"{name}: A/z must be float32")
    if not (A.is_contiguous() and z.is_contiguous()):
        raise ValueError(f"{name}: A/z must be contiguous")


def armt_read(x, wq, A, z, *, nu: int = 3, config=None, use_kernel=None):
    """x: [N,T,D]; wq: [D,dm] or [G,D,dm]; A: [N,P,Dv]; z: [N,P] ->
    [N,T,Dv] in x.dtype. A CPU tensor takes the plain version; a CUDA
    tensor launches the kernel or raises (``use_kernel=False`` takes the
    plain version there). With gradients on and an operand that requires
    one, the call goes through ``ArmtReadFn``."""
    cfg = dispatch.config_for("armt_read", (x.shape, A.shape), x, config, use_kernel)
    if needs_grad(x, wq, A, z):
        return ArmtReadFn.apply(x, wq, A, z, nu, cfg)
    return _armt_read(x, wq, A, z, nu=nu, cfg=cfg)


class ArmtReadFn(torch.autograd.Function):
    """``armt_read`` under autograd: the kernels (on the CPU the plain
    version) forward; backward ``grad.armt_read_bwd`` from the operands
    (q, phi(q), num and den recomputed in fp32)."""

    @staticmethod
    def forward(ctx, x, wq, A, z, nu, cfg):
        ctx.nu = nu
        ctx.save_for_backward(x, wq, A, z)
        return _armt_read(x, wq, A, z, nu=nu, cfg=cfg)

    @staticmethod
    def backward(ctx, g):
        return grad.armt_read_bwd(*ctx.saved_tensors, g, nu=ctx.nu) + (None, None)


def _armt_read(x, wq, A, z, *, nu: int, cfg):
    if cfg.impl == "plain":
        return armt_read_plain(x, wq, A, z, nu=nu)
    if x.device.type != "cuda":
        raise ValueError(f"armt_read: the CUDA kernels need a CUDA tensor, got {x.device}")
    if x.dim() != 3 or not x.is_contiguous():
        raise ValueError(f"armt_read: x {tuple(x.shape)} must be contiguous 3-D")
    N, T, D = x.shape
    batch = _weight_groups(wq, N, D, "armt_read")
    dm = wq.shape[-1]
    P = 2 * nu * dm
    if not (1 <= nu <= MAX_NU and dm <= MAX_D_MEM):
        raise ValueError(f"armt_read: nu={nu}, d_mem={dm} unsupported")
    _check_state(A, z, N, P, "armt_read")
    Dv = A.shape[2]
    if x.dtype not in _DTYPE or wq.dtype != x.dtype:
        raise ValueError(f"armt_read: dtypes {x.dtype}/{wq.dtype}")
    if not (x.device == wq.device == A.device == z.device):
        raise ValueError("armt_read: operands on different devices")
    out = torch.empty(N, T, Dv, dtype=x.dtype, device=x.device)
    if N * T * Dv == 0:
        return out
    global read_launches
    read_launches += 1
    q = project_f32(x, wq, batch)
    lib, stream = build.lib(), build.stream_ptr(x)
    if x.dtype == torch.float32:
        build.check(lib.armt_read_launch(q.data_ptr(), A.data_ptr(), z.data_ptr(),
                                         out.data_ptr(), N, T, dm, P, Dv, stream), "armt_read")
        return out
    # bf16: phi's and A's splits (rows padded to 16 bytes for the TMA), then
    # the three-term product with the division in its epilogue
    sp, sw = -(-P // 8) * 8, -(-Dv // 8) * 8
    phi = torch.empty(N, 2, T, sp, dtype=torch.bfloat16, device=x.device)
    W = torch.empty(N, 2, P, sw, dtype=torch.bfloat16, device=x.device)
    den = torch.empty(N, T, dtype=torch.float32, device=x.device)
    build.check(lib.armt_read_split_launch(
        q.data_ptr(), A.data_ptr(), z.data_ptr(), phi.data_ptr(), W.data_ptr(), den.data_ptr(),
        N, T, dm, P, Dv, sp, sw, stream), "armt_read")
    build.check(lib.armt_read_gemm_launch(
        phi.data_ptr(), W.data_ptr(), den.data_ptr(), out.data_ptr(), N, T, P, Dv, sp, sw,
        cfg.block_n, stream), "armt_read")
    return out


def check_update(m, wk, wv, wb, A, z, *, nu: int):
    """Validates armt_update's operands on the card; returns the launch
    dims (N, M, dm, P, Dv, weight batch)."""
    if m.dim() != 3 or m.stride(2) != 1:
        raise ValueError(f"armt_update: m {tuple(m.shape)} needs a contiguous last dim")
    N, M, D = m.shape
    batch = _weight_groups(wk, N, D, "armt_update")
    for w in (wv, wb):
        if _weight_groups(w, N, D, "armt_update") != batch:
            raise ValueError("armt_update: wk/wv/wb group counts differ")
    dm = wk.shape[-1]
    P = 2 * nu * dm
    if not (1 <= nu <= MAX_NU and dm <= MAX_D_MEM and M <= MAX_MEM_TOKENS):
        raise ValueError(f"armt_update: nu={nu}, d_mem={dm}, M={M} unsupported")
    if wb.shape[-1] != 1:
        raise ValueError(f"armt_update: wb {tuple(wb.shape)} must end in 1")
    _check_state(A, z, N, P, "armt_update")
    Dv = A.shape[2]
    if wv.shape[-1] != Dv:
        raise ValueError(f"armt_update: wv {tuple(wv.shape)} vs Dv={Dv}")
    if m.dtype not in _DTYPE or any(w.dtype != m.dtype for w in (wk, wv, wb)):
        raise ValueError(f"armt_update: dtypes {m.dtype}/{wk.dtype}/{wv.dtype}/{wb.dtype}")
    if any(t.device != m.device for t in (wk, wv, wb, A, z)):
        raise ValueError("armt_update: operands on different devices")
    return N, M, dm, P, Dv, batch


def launch_update(m, wk, wv, wb, A, z, dims):
    """The update's launches on operands ``check_update`` accepted ->
    (A', z', whether a kernel was launched). Counts nothing."""
    N, M, dm, P, Dv, batch = dims
    A_out = torch.empty_like(A)
    z_out = torch.empty_like(z)
    if N == 0 or M == 0:
        A_out.copy_(A)
        z_out.copy_(z)
        return A_out, z_out, False
    k = project_f32(m, wk, batch)
    v = project_f32(m, wv, batch)
    Pp = -(-P // PHI_CHUNK) * PHI_CHUNK
    phi = torch.empty(N, M, Pp, dtype=torch.float32, device=m.device)
    aux = torch.empty(N, 3, M, dtype=torch.float32, device=m.device)
    code = build.lib().armt_update_launch(
        k.data_ptr(), v.data_ptr(), m.data_ptr(), wb.data_ptr(), A.data_ptr(),
        z.data_ptr(), A_out.data_ptr(), z_out.data_ptr(), phi.data_ptr(), aux.data_ptr(),
        N, M, dm, P, Pp, Dv, m.shape[2], m.stride(0), m.stride(1), batch, _DTYPE[m.dtype],
        build.stream_ptr(m))
    build.check(code, "armt_update")
    return A_out, z_out, True


def armt_update(m, wk, wv, wb, A, z, *, nu: int = 3, config=None, use_kernel=None):
    """m: [N,M,D] (rows may be strided; the last dim contiguous); wk/wv/wb:
    [D,*] or [G,D,*]; A: [N,P,Dv]; z: [N,P] -> (A', z') in new buffers.
    A CPU tensor takes the plain version; a CUDA tensor launches the kernels
    or raises (``use_kernel=False`` takes the plain version there). With
    gradients on and an operand that requires one, the call goes through
    ``ArmtUpdateFn``."""
    cfg = dispatch.config_for("armt_update", (m.shape, A.shape), m, config, use_kernel)
    if needs_grad(m, wk, wv, wb, A, z):
        return ArmtUpdateFn.apply(m, wk, wv, wb, A, z, nu, cfg)
    return _armt_update(m, wk, wv, wb, A, z, nu=nu, cfg=cfg)


class ArmtUpdateFn(torch.autograd.Function):
    """``armt_update`` under autograd: the kernels (on the CPU the plain
    version) forward; backward ``grad.armt_update_bwd`` from the operands
    (k, v, beta, phi(k), vbar and gamma recomputed in fp32)."""

    @staticmethod
    def forward(ctx, m, wk, wv, wb, A, z, nu, cfg):
        ctx.nu = nu
        ctx.save_for_backward(m, wk, wv, wb, A, z)
        return _armt_update(m, wk, wv, wb, A, z, nu=nu, cfg=cfg)

    @staticmethod
    def backward(ctx, gA, gz):
        return grad.armt_update_bwd(*ctx.saved_tensors, gA, gz, nu=ctx.nu) + (None, None)


def _armt_update(m, wk, wv, wb, A, z, *, nu: int, cfg):
    global update_launches
    if cfg.impl == "plain":
        return armt_update_plain(m, wk, wv, wb, A, z, nu=nu)
    if m.device.type != "cuda":
        raise ValueError(f"armt_update: the CUDA kernels need a CUDA tensor, got {m.device}")
    A_out, z_out, launched = launch_update(
        m, wk, wv, wb, A, z, check_update(m, wk, wv, wb, A, z, nu=nu))
    if launched:
        update_launches += 1
    return A_out, z_out
