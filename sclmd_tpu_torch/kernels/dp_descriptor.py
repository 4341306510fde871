"""K13: DeepPot-SE's descriptor from the embedding net's last hidden
activation (``models.nnp.DeepPotSE``), forward and input gradient.

For each atom's row of nn table entries, with h2 (..., na, nn, h) the
embedding's last hidden activation of each entry, R (..., na, nn, 4) the
entries' environment rows (zero on padding entries) and (W3_t, b3_t) the
embedding's last layer of neighbour type t, which is linear:

    G^T = sum_t ((R_t^T h2) W3_t + (R_t^T 1) b3_t^T) / nn      (..., na, 4, E)
    D   = (G^T)^T G^T[..., :naxis], flattened                  (..., na, E naxis)

R_t keeps the rows of the entries of type t and zeroes the others. That
is the per-entry form G^T = R^T (h2 W3 + b3) / nn with the last layer
moved past the sum over entries, exact for a linear layer: no E-wide
tensor exists per entry.

``descriptor`` runs the plain twin ``descriptor_plain``, the same
reassociated arithmetic in torch, on CPU tensors, and on CUDA tensors the
hand kernels (csrc/dp_descriptor.cu, a forward and its gradient, in a
``torch.autograd.Function``), which take float32 alone and weights that
take no gradient, and refuse widths beyond theirs (``DP_MAX_*`` there).
A float64 run on the card takes the twin at the model
(``models.nnp.DeepPotSE.energy``).
"""

from __future__ import annotations

import ctypes

import torch
from torch.autograd.function import once_differentiable

from sclmd_tpu_torch.kernels import build
from sclmd_tpu_torch.utils import profiling

launches = 0   # forward launches: the descriptors that went through K13


def reset_count():
    global launches
    launches = 0


profiling.register("launches.DP_desc", __name__, "launches")


def descriptor_plain(h2, R, w3, b3, ntype, naxis: int) -> torch.Tensor:
    """Plain torch twin: D (..., na, E naxis) from h2 (..., na, nn, h), R
    (..., na, nn, 4), the last layer's weights ``w3`` [(h, E)] and biases
    ``b3`` [(E,)] by neighbour type, and ``ntype`` (na, nn) (None with one
    type)."""
    nn = R.shape[-2]
    GT = None
    for t, (w, b) in enumerate(zip(w3, b3)):
        Rt = R if ntype is None else \
            torch.where((ntype == t)[..., None], R, torch.zeros_like(R))
        Rt = Rt.transpose(-1, -2)                          # (..., na, 4, nn)
        g = torch.matmul(torch.matmul(Rt, h2), w) + \
            Rt.sum(-1, keepdim=True) * b
        GT = g if GT is None else GT + g
    GT = GT / nn
    D = torch.matmul(GT.transpose(-1, -2), GT[..., :naxis])
    return D.reshape(D.shape[:-2] + (-1,))


class _Args(ctypes.Structure):
    _fields_ = [(n, ctypes.c_void_p) for n in
                ("h2", "R", "ntype", "w3", "b3", "D", "GT", "dD", "dh2",
                 "dR")] + \
               [(n, ctypes.c_int) for n in
                ("rows", "na", "nn", "h", "e", "naxis", "nt")]


def _args(h2, R, w3, b3, ntype, naxis) -> _Args:
    *lead, na, nn, h = h2.shape
    if R.shape != (*lead, na, nn, 4) or w3.shape[-2] != h or (
            ntype is not None and ntype.shape != (na, nn)):
        raise ValueError("dp_descriptor: h2, R, W3 and the types disagree "
                         "in shape")
    a = _Args()
    a.h2, a.R = h2.data_ptr(), R.data_ptr()
    a.ntype = 0 if ntype is None else ntype.data_ptr()
    a.w3, a.b3 = w3.data_ptr(), b3.data_ptr()
    a.rows, a.na, a.nn, a.h = h2.numel() // (nn * h), na, nn, h
    a.e, a.naxis = w3.shape[-1], naxis
    a.nt = 1 if w3.dim() == 2 else w3.shape[0]
    return a


class _DescriptorCuda(torch.autograd.Function):
    """K13's forward and its gradient to h2 and R (the weights take
    none)."""

    @staticmethod
    def forward(ctx, h2, R, w3, b3, ntype, naxis):
        global launches
        a = _args(h2, R, w3, b3, ntype, naxis)
        lead = h2.shape[:-2]
        D = torch.empty(lead + (a.e * naxis,), dtype=h2.dtype,
                        device=h2.device)
        GT = torch.empty(lead + (a.e, 4), dtype=h2.dtype, device=h2.device)
        a.D, a.GT = D.data_ptr(), GT.data_ptr()
        rc = build.load().dp_descriptor_f32(ctypes.byref(a),
                                      build.current_stream(h2.device))
        build.check(rc, "dp_descriptor")
        launches += 1
        ctx.save_for_backward(h2, R, w3, b3, ntype, GT)
        ctx.naxis = naxis
        return D

    @staticmethod
    @once_differentiable
    def backward(ctx, dD):
        h2, R, w3, b3, ntype, GT = ctx.saved_tensors
        a = _args(h2, R, w3, b3, ntype, ctx.naxis)
        dD = dD.contiguous()
        dh2, dR = torch.empty_like(h2), torch.empty_like(R)
        a.GT, a.dD = GT.data_ptr(), dD.data_ptr()
        a.dh2, a.dR = dh2.data_ptr(), dR.data_ptr()
        rc = build.load().dp_descriptor_grad_f32(ctypes.byref(a),
                                           build.current_stream(h2.device))
        build.check(rc, "dp_descriptor_grad")
        return dh2, dR, None, None, None, None


def descriptor(h2, R, w3, b3, ntype, naxis: int) -> torch.Tensor:
    """D (..., na, E naxis): the twin for CPU tensors, K13 for CUDA
    tensors. ``w3``, ``b3``: the last layer's weights (h, E) and biases
    (E,), a list by neighbour type; ``ntype``: (na, nn) types (None with
    one)."""
    if h2.device.type == "cpu" and R.device.type == "cpu":
        return descriptor_plain(h2, R, w3, b3, ntype, naxis)
    if h2.dtype != torch.float32 or R.dtype != torch.float32:
        raise TypeError("dp_descriptor: the kernel takes float32 (got "
                        f"{h2.dtype}, {R.dtype}); a float64 run takes "
                        "descriptor_plain")
    if any(t.requires_grad for t in (*w3, *b3)):
        raise ValueError("dp_descriptor: the kernel gives no gradient to "
                         "the weights")
    W = w3[0] if len(w3) == 1 else torch.stack(w3)
    B = b3[0] if len(b3) == 1 else torch.stack(b3)
    nt = None if len(w3) == 1 else ntype.to(torch.int32).contiguous()
    return _DescriptorCuda.apply(h2.contiguous(), R.contiguous(),
                                 W.contiguous(), B.contiguous(), nt, naxis)
