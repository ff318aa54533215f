"""Grouped matmul with a fused bias + activation epilogue, and the fused
down projection + ARMT update of the B == 1 cell.

``grouped_matmul`` replaces the Pallas kernel ``grouped_matmul``
(repro/kernels/grouped_matmul.py:198): ``x[G,R,K] @ w[G,K,N] (+ bias[G,N])``
with silu or tanh-gelu applied to the fp32 accumulator. With a layer index
``widx`` (int32 [G] on the device) group i reads ``w[widx[i]]`` and
``bias[widx[i]]`` of a stack of any depth, in place of ``w[i]``: a pooled
band step (``core/diagonal.py`` ``pipeline_step_pool``) runs the bands of
several pipelines, each group with its own layer, in one launch over the
model's own stacked weights, with no gathered copy; each group's sums are
the ones it gets alone (the k loop does not depend on the other groups).
Its plain version is
``grouped_matmul_plain``. Every launch takes one of two routes in
``csrc/grouped_matmul.cu``, which ``route()`` picks and the module counts:
the TMA + wgmma mainloop for bf16 operands with 16-byte rows, the fp32 SIMT
kernel for the rest.

``grouped_matmul_armt_update`` replaces the Pallas kernel of that name
(repro/kernels/grouped_matmul.py:114): ``y = res + x @ w (+ bias)``, the
residual added to the fp32 accumulator before the one cast, then the ARMT
delta-rule update of (A, z) from the last M rows of each group's y. On the
card the GEMM with its residual epilogue is one launch of the kernel in
``csrc/grouped_matmul.cu``, and the update runs the ``armt_update`` kernels
of ``csrc/armt_memory.cu`` on a strided view of y's memory rows (see the
CUDA source for why the update cannot stay on chip; the memory rows are
read back from L2). One call counts as one
``grouped_matmul_armt_update`` launch and as no ``grouped_matmul`` or
``armt_update`` launch. Unlike the TPU kernel it has no tiling constraint
on where the memory rows sit, and so no fallback.

``project_f32`` runs the GEMM kernel with an fp32 epilogue for the ARMT
memory kernels' projections (their launches count as theirs, not here).

Under gradients ``grouped_matmul`` runs through ``GroupedMatmulFn``: the
kernel forward, and a backward in PyTorch ops (``kernels/grad.py``) that
recomputes the pre-activation with the kernel (an fp32 epilogue, counted
as a launch). The fused update is forward-only.
"""
from __future__ import annotations

import sys

import torch

from repro_torch.kernels import build, grad
from repro_torch.kernels.grad import needs_grad
from repro_torch.kernels.ref import grouped_matmul_armt_update_ref as \
    grouped_matmul_armt_update_plain
from repro_torch.kernels.ref import grouped_matmul_ref as grouped_matmul_plain

launches = 0         # grouped_matmul launches since the last reset
fused_launches = 0   # grouped_matmul_armt_update launches since the last reset
# GEMM kernel launches by route since the last reset, whoever called launch()
# (grouped_matmul, the fused op, project_f32)
tc_launches = 0      # the TMA + wgmma mainloop
simt_launches = 0    # gmm_simt, fp32 FMAs
build.count_launches(sys.modules[__name__], "launches", "fused_launches", "tc_launches",
                     "simt_launches")

_ACT = {None: 0, "silu": 1, "gelu": 2}
_DTYPE = {torch.float32: 0, torch.bfloat16: 1}


def _x_strides(x):
    """x's (group, row) strides, those of a size-1 dim replaced by the
    stride a contiguous tensor would have there: PyTorch leaves a size-1
    dim's stride arbitrary, and the TMA tensor map needs a real one."""
    G, R, K = x.shape
    sxr = x.stride(1) if R > 1 else K
    return (x.stride(0) if G > 1 else R * sxr), sxr


def route(x, w, out) -> str:
    """The kernel a launch of these operands takes: "wgmma" (the TMA +
    wgmma mainloop: bf16, K > 0, K and N multiples of 8 and 16-byte-aligned
    x rows, so every row the TMA reads is whole 16-byte pieces; x, w and out
    16-byte aligned) or "simt" (any dtype and shape)."""
    K, N = w.shape[-2:]
    sxg, sxr = _x_strides(x)
    if (x.dtype == torch.bfloat16 and K > 0 and K % 8 == 0 and N % 8 == 0
            and sxg > 0 and sxr > 0 and sxg % 8 == 0 and sxr % 8 == 0
            and all(t.data_ptr() % 16 == 0 for t in (x, w, out))):
        return "wgmma"
    return "simt"


def _check_widx(widx, G: int, x) -> None:
    if (widx.dtype != torch.int32 or widx.shape != (G,) or not widx.is_contiguous()
            or widx.device != x.device):
        raise ValueError(f"grouped_matmul: widx must be a contiguous int32 [{G}] tensor "
                         f"on {x.device}, got {widx.dtype} {tuple(widx.shape)} on "
                         f"{widx.device}")


def launch(x, w, bias, out, *, wbatch: int = 1, activation=None, res=None, widx=None):
    """out[i] = act(x[i] @ w[j] + bias[j]) (+ res[i]) on the card, j = i //
    wbatch, or widx[i] with a layer index; res added to the fp32
    accumulator before the cast. x: [G,R,K] and res: [G,R,N], each with a
    contiguous last dim; w: [G/wbatch,K,N] contiguous, or [Lw,K,N] with
    widx (int32 [G] on the device, values in [0, Lw), not checked on the
    host); out: [G,R,N] contiguous, in x.dtype or float32. Returns whether a
    kernel was launched (nothing is launched for an empty output)."""
    if x.dim() != 3 or w.dim() != 3:
        raise ValueError(f"grouped_matmul: x {tuple(x.shape)} and w "
                         f"{tuple(w.shape)} must be 3-D")
    G, R, K = x.shape
    if widx is not None:
        _check_widx(widx, G, x)
        if wbatch != 1 or w.shape[1] != K:
            raise ValueError(f"grouped_matmul: x {tuple(x.shape)} vs w {tuple(w.shape)} "
                             f"with a layer index (wbatch {wbatch})")
    elif G % wbatch or w.shape[:2] != (G // wbatch, K):
        raise ValueError(f"grouped_matmul: x {tuple(x.shape)} vs w {tuple(w.shape)}")
    Lw, N = w.shape[0], w.shape[2]
    if x.dtype not in _DTYPE or w.dtype != x.dtype:
        raise ValueError(f"grouped_matmul: dtypes {x.dtype}/{w.dtype}")
    if x.stride(2) != 1:
        raise ValueError("grouped_matmul: x's last dim must be contiguous")
    if not w.is_contiguous():
        raise ValueError("grouped_matmul: w must be contiguous")
    if bias is not None and (bias.shape != (Lw, N) or bias.dtype != x.dtype
                             or not bias.is_contiguous()):
        raise ValueError(f"grouped_matmul: bias {tuple(bias.shape)} {bias.dtype}")
    if out.shape != (G, R, N) or not out.is_contiguous() or \
            out.dtype not in (x.dtype, torch.float32):
        raise ValueError(f"grouped_matmul: out {tuple(out.shape)} {out.dtype}")
    if res is not None and (res.shape != (G, R, N) or res.dtype != x.dtype
                            or res.stride(2) != 1):
        raise ValueError(f"grouped_matmul: res {tuple(res.shape)} {res.dtype}")
    if any(t is not None and t.device != x.device for t in (w, bias, res, out)):
        raise ValueError("grouped_matmul: operands on different devices")
    if G * R * N == 0:
        return False
    global tc_launches, simt_launches
    tc = route(x, w, out) == "wgmma"
    code = build.lib().gmm_launch(
        x.data_ptr(), w.data_ptr(), bias.data_ptr() if bias is not None else None,
        res.data_ptr() if res is not None else None, out.data_ptr(), G, R, K, N,
        *_x_strides(x), res.stride(0) if res is not None else 0,
        res.stride(1) if res is not None else 0, wbatch,
        widx.data_ptr() if widx is not None else None, Lw, _DTYPE[x.dtype],
        int(out.dtype == torch.float32), _ACT[activation], int(tc), build.stream_ptr(x))
    build.check(code, "grouped_matmul")
    if tc:
        tc_launches += 1
    else:
        simt_launches += 1
    return True


def grouped_matmul(x, w, bias=None, *, activation: str | None = None, widx=None,
                   res=None, out=None):
    """x: [G,R,K] (rows may be strided; the last dim contiguous), w:
    [G,K,N] contiguous, bias: [G,N] or None -> [G,R,N] in x.dtype. widx:
    int32 [G] layer index into w [Lw,K,N] (and bias [Lw,N]): group i reads
    w[widx[i]]. res: [G,R,N] in x.dtype (rows may be strided), added to the
    fp32 accumulator before the cast (the fused update's residual
    epilogue, without the update). out: a contiguous [G,R,N] tensor to
    write the result into (and return), e.g. a view of a state buffer; a
    new one in x.dtype when None.

    A CPU tensor takes the plain version; a CUDA tensor launches the kernel
    or raises. With gradients on and an operand that requires one, the call
    goes through ``GroupedMatmulFn`` (its backward in ``kernels/grad.py``);
    widx and out are forward-only."""
    if needs_grad(x, w, bias, res):
        if widx is not None or out is not None:
            raise ValueError("grouped_matmul: widx and out= are forward-only")
        return GroupedMatmulFn.apply(x, w, bias, res, activation)
    return _grouped_matmul(x, w, bias, activation=activation, widx=widx, res=res, out=out)


def _grouped_matmul(x, w, bias=None, *, activation=None, widx=None, res=None, out=None):
    global launches
    if x.device.type == "cpu":
        return grouped_matmul_plain(x, w, bias, activation=activation, widx=widx, res=res,
                                    out=out)
    if x.device.type != "cuda":
        raise ValueError(f"grouped_matmul: unsupported device {x.device}")
    if activation not in _ACT:
        raise ValueError(f"grouped_matmul: unknown activation {activation!r}")
    if out is None:
        out = torch.empty(x.shape[0], x.shape[1], w.shape[-1], dtype=x.dtype,
                          device=x.device)
    if launch(x, w, bias, out, activation=activation, widx=widx, res=res):
        launches += 1
    return out


class GroupedMatmulFn(torch.autograd.Function):
    """``grouped_matmul`` under autograd: the kernel (or, on the CPU, its
    plain version) forward; backward, the pre-activation recomputed with
    the kernel (no activation, fp32 out), then ``grad.grouped_matmul_bwd``;
    res's gradient is dy."""

    @staticmethod
    def forward(ctx, x, w, bias, res, activation):
        ctx.activation = activation
        ctx.save_for_backward(x, w, bias)
        return _grouped_matmul(x, w, bias, activation=activation, res=res)

    @staticmethod
    def backward(ctx, dy):
        x, w, bias = ctx.saved_tensors
        pre = None
        if ctx.activation is not None:
            pre = _grouped_matmul(x, w, bias, out=torch.empty(
                x.shape[0], x.shape[1], w.shape[-1], dtype=torch.float32, device=x.device))
        dx, dw, db = grad.grouped_matmul_bwd(x, w, bias, dy, pre, ctx.activation,
                                             ctx.needs_input_grad[:3])
        return dx, dw, db, dy if ctx.needs_input_grad[3] else None, None


def grouped_matmul_armt_update(x, w, res, wk, wv, wb, A, z, bias=None, *,
                               M: int, nu: int = 3, widx=None):
    """x: [G,R,K] (rows may be strided; the last dim contiguous); w: [G,K,N]
    contiguous; res: [G,R,N] in x.dtype (last dim contiguous); bias: [G,N]
    or None; wk/wv/wb: [N,*] or [G,N,*]; A: [G,P,Dv]; z: [G,P] ->
    (y [G,R,N] in x.dtype, A', z' in new buffers). widx: the GEMM's layer
    index into w [Lw,K,N] (see ``grouped_matmul``); wk/wv/wb stay per group.

    A CPU tensor takes the plain version; a CUDA tensor launches the kernels
    or raises. Forward-only: under gradients the cell runs ``grouped_matmul``
    with ``res`` and then ``armt_update``, the same function."""
    global fused_launches
    if needs_grad(x, w, res, wk, wv, wb, A, z, bias):
        raise ValueError("grouped_matmul_armt_update is forward-only: under gradients "
                         "take grouped_matmul(res=) and armt_update")
    if x.device.type == "cpu":
        return grouped_matmul_armt_update_plain(x, w, res, wk, wv, wb, A, z, bias,
                                                M=M, nu=nu, widx=widx)
    if x.device.type != "cuda":
        raise ValueError(f"grouped_matmul_armt_update: unsupported device {x.device}")
    from repro_torch.kernels import armt_memory   # it imports this module
    if x.dim() != 3 or w.dim() != 3:
        raise ValueError(f"grouped_matmul_armt_update: x {tuple(x.shape)} and w "
                         f"{tuple(w.shape)} must be 3-D")
    G, R, _ = x.shape
    if not 0 < M <= R:
        raise ValueError(f"grouped_matmul_armt_update: M={M} vs {R} rows")
    y = torch.empty(G, R, w.shape[-1], dtype=x.dtype, device=x.device)
    mem = y[:, R - M:, :]                   # the memory rows, a strided view
    dims = armt_memory.check_update(mem, wk, wv, wb, A, z, nu=nu)
    launched = launch(x, w, bias, y, res=res, widx=widx)
    A2, z2, _ = armt_memory.launch_update(mem, wk, wv, wb, A, z, dims)
    if launched:
        fused_launches += 1
    return y, A2, z2


def project_f32(x, w, batch: int):
    """fp32 ``x[n] @ w[n // batch]`` on the card for the ARMT kernels. x:
    [N,R,D]; w: [D,E] (shared) or [G,D,E] with N = G*batch -> [N,R,E] fp32.
    bf16 x bf16 products are exact in fp32, so this is the reference's fp32
    projection up to summation order."""
    if w.dim() == 2:
        w, batch = w[None], x.shape[0]
    out = torch.empty(x.shape[0], x.shape[1], w.shape[-1], dtype=torch.float32,
                      device=x.device)
    launch(x, w, None, out, wbatch=batch)
    return out
