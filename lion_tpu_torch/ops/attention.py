"""Softmax attention over tokens, fused, forward and backward (the DiT
blocks of `nn/dit.py`; no TPU kernel: the JAX package has no softmax
attention over tokens, and its only attention, `LinearAttention`, is
O(N d^2)).

    o = softmax(q k^T * scale) v,   q (N, H, L, d), k, v (N, H, Lk, d)

The kernels are `csrc/attention.cu`, exact fp32 FFMA (its header gives
the design): `dit_attn_fwd` writes o and each row's logsumexp and keeps
no L x Lk matrix in device memory; the backward is `dit_attn_bwd_delta`
(rowsum(dO * O)), `dit_attn_bwd_dkdv` (a key block walks the query
tiles) and `dit_attn_bwd_dq` (a query block walks the key tiles), the
probabilities recomputed from the logsumexp. Every sum is taken in a
fixed order, so they repeat bit for bit; `tf32=True` rounds every
operand to TF32 first, as TF32 tensor cores take them (the benchmark's
control). They take DiT-XL's head dim of 72, L and Lk multiples
of 64, and q, k, v through their strides with each row contiguous and
16-byte aligned: the views of a packed qkv projection are taken as they
are. Global attention over a cloud's 4096 tokens and the 64-token 3-D
windows (put on the batch axis by their partition, `nn.dit`) run the same
kernels.

The plain versions (the CPU's path) compute the same functions in query
chunks of `PLAIN_CHUNK` rows, with TF32's rounding where the kernels
round.
"""
import ctypes
import math

import torch

from ._cuda import kernel, launch, no_tf32, ptr, stream_of

PLAIN_CHUNK = 1024


def tf32_round(x: torch.Tensor) -> torch.Tensor:
    """float32 x rounded to TF32's 10-bit mantissa, to nearest with ties
    away from zero (the kernels' cvt.rna.tf32.f32)."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32).reshape(x.shape)


def _plain_attention_forward(q, k, v, scale: float, tf32: bool = False):
    """-> (o (N, H, L, d), lse (N * H, L)): the natural logsumexp of each
    query's scaled logits; o a view of an (N, L, H, d) tensor, as the
    kernel gives it. With `tf32` the products' operands are rounded to
    TF32 where the kernel rounds them (q, k, v and the probabilities)."""
    r = tf32_round if tf32 else (lambda t: t)
    n, h, length, d = q.shape
    o = torch.empty((n, length, h, d), dtype=q.dtype,
                    device=q.device).transpose(1, 2)
    lse = torch.empty((n, h, length), dtype=q.dtype, device=q.device)
    kt, vr = r(k).transpose(-2, -1), r(v)
    with no_tf32():
        for i in range(0, length, PLAIN_CHUNK):
            rows = slice(i, i + PLAIN_CHUNK)
            s = torch.matmul(r(q[:, :, rows]), kt) * scale
            m = s.amax(dim=-1, keepdim=True)
            p = torch.exp(s - m)
            total = p.sum(dim=-1, keepdim=True)
            o[:, :, rows] = torch.matmul(r(p), vr) / total
            lse[:, :, rows] = (m + torch.log(total))[..., 0]
    return o, lse.reshape(n * h, length)


def _plain_attention_backward(q, k, v, o, lse, do, scale: float,
                              tf32: bool = False):
    """-> (dq, dk, dv) in q's, k's and v's shapes, the probabilities
    recomputed from the logsumexp; with `tf32` the products' operands
    rounded where the kernel rounds them (q, k, v, dO, P and dS)."""
    r = tf32_round if tf32 else (lambda t: t)
    n, h, length, d = q.shape
    lse = lse.reshape(n, h, length, 1)
    delta = (do * o).sum(dim=-1, keepdim=True)
    qr, kr, vr, dor = r(q), r(k), r(v), r(do)
    dq = torch.empty_like(q)
    dk = torch.zeros(k.shape, dtype=k.dtype, device=k.device)
    dv = torch.zeros(v.shape, dtype=v.dtype, device=v.device)
    with no_tf32():
        for i in range(0, length, PLAIN_CHUNK):
            rows = slice(i, i + PLAIN_CHUNK)
            qc, doc = qr[:, :, rows], dor[:, :, rows]
            p = torch.exp(torch.matmul(qc, kr.transpose(-2, -1)) * scale
                          - lse[:, :, rows])
            dv += torch.matmul(r(p).transpose(-2, -1), doc)
            ds = r(p * (torch.matmul(doc, vr.transpose(-2, -1))
                        - delta[:, :, rows]))
            dq[:, :, rows] = torch.matmul(ds, kr) * scale
            dk += torch.matmul(ds.transpose(-2, -1), qc) * scale
    return dq, dk, dv


# the head dims the kernels are built for: DiT-XL/2's
KERNEL_HEAD_DIMS = (72,)


def _strides(t: torch.Tensor):
    """(item, head, row) strides of an (N, H, L, d) tensor whose rows are
    contiguous and 16-byte aligned."""
    if t.stride(3) != 1 or t.data_ptr() % 16 or any(
            s % 4 for s in t.stride()[:3]):
        raise ValueError("attention: each row of q, k, v, o and dO must be "
                         "contiguous and 16-byte aligned")
    return list(t.stride()[:3])


def _check(q, k, v):
    for t in (q, k, v):
        if not t.is_cuda or t.dtype != torch.float32:
            raise TypeError(f"attention: expected float32 CUDA tensors, got "
                            f"{t.dtype} on {t.device}")
    d, length, lk = q.shape[3], q.shape[2], k.shape[2]
    if d not in KERNEL_HEAD_DIMS or length % 64 or lk % 64:
        raise ValueError(f"attention: the kernel takes head dims "
                         f"{KERNEL_HEAD_DIMS} and lengths that are multiples "
                         f"of 64, got d {d}, L {length}, Lk {lk}")


def _int_array(values):
    return (ctypes.c_int * len(values))(*values)


@kernel("attention", _plain_attention_forward,
        "lion_tpu_torch/csrc/attention.cu", "none (softmax attention over tokens: DiT-3D's blocks)")
def attention_forward(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                      scale: float, tf32: bool = False):
    """q (N, H, L, d), k, v (N, H, Lk, d) float32 on the card -> (o (N, H,
    L, d), a view of a contiguous (N, L, H, d); lse (N * H, L))."""
    _check(q, k, v)
    n, h, length, d = q.shape
    o = torch.empty((n, length, h, d), dtype=q.dtype,
                    device=q.device).transpose(1, 2)
    lse = torch.empty((n * h, length), dtype=torch.float32, device=q.device)
    strides = _int_array(_strides(q) + _strides(k) + _strides(v)
                         + _strides(o))
    launch("lion_dit_attention_fwd", ptr(q), ptr(k), ptr(v), ptr(o),
           ptr(lse), ctypes.addressof(strides), n, h, length, k.shape[2], d,
           scale, int(tf32), stream_of(q))
    return o, lse


@kernel("attention_backward", _plain_attention_backward,
        "lion_tpu_torch/csrc/attention.cu",
        "none (the gradient of `attention`)")
def attention_backward(q, k, v, o, lse, do, scale: float,
                       tf32: bool = False):
    """-> (dq, dk, dv), each contiguous in its input's shape."""
    _check(q, k, v)
    n, h, length, d = q.shape
    dq = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    dk = torch.empty(k.shape, dtype=k.dtype, device=k.device)
    dv = torch.empty(v.shape, dtype=v.dtype, device=v.device)
    delta = torch.empty_like(lse)
    strides = _int_array(_strides(q) + _strides(k) + _strides(v)
                         + _strides(o) + _strides(do) + _strides(dq)
                         + _strides(dk))
    launch("lion_dit_attention_bwd", ptr(q), ptr(k), ptr(v), ptr(o),
           ptr(do), ptr(lse), ptr(delta), ptr(dq), ptr(dk), ptr(dv),
           ctypes.addressof(strides), n, h, length, k.shape[2], d, scale,
           int(tf32), stream_of(q))
    return dq, dk, dv


class _Attention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, scale, tf32):
        o, lse = attention_forward(q, k, v, scale, tf32)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.scale, ctx.tf32 = scale, tf32
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        if do.stride(-1) != 1 or do.data_ptr() % 16 or any(
                s % 4 for s in do.stride()[:3]):
            do = do.contiguous()
        dq, dk, dv = attention_backward(q, k, v, o, lse, do, ctx.scale,
                                        ctx.tf32)
        return dq, dk, dv, None, None


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              scale: float = None, tf32: bool = False) -> torch.Tensor:
    """softmax(q k^T * scale) v over (N, H, L, d) tensors (scale 1 /
    sqrt(d) by default), with a gradient to q, k and v; `tf32` runs the
    products in TF32 (the check's control) instead of IEEE float32."""
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])
    return _Attention.apply(q, k, v, scale, tf32)
