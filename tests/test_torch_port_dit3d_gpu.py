"""DiT-3D's fused attention (`lion_tpu_torch.ops.attention`, the CUDA
kernels of `csrc/attention.cu`) on the card against the plain reference's
attention (`benchmark/reference_dit3d`) in float64, forward and backward,
at DiT-XL/2's shapes: B4 x 16 heads x 4096 tokens x head dim 72 (the
global blocks) and the 64-token windows of the same clouds (B4 x 64
windows on the batch axis). In IEEE float32 each
output and gradient lies within `TOL` of float64; with TF32 products it
must not (the tolerance separates the two precisions).

Needs an NVIDIA GPU: every test is marked `gpu` and skips without CUDA.
This file imports no JAX:

    python -m pytest --noconftest -p no:cacheprovider -q \\
        tests/test_torch_port_dit3d_gpu.py
"""
import math

import pytest
import torch

from benchmark.reference_dit3d import softmax_attention
from lion_tpu_torch import ops
from lion_tpu_torch.ops.attention import attention

pytestmark = pytest.mark.gpu
SHAPES = {"global": (4, 16, 4096, 72), "window": (4 * 64, 16, 64, 72)}
# relative L2 error against float64 of the output and of each gradient:
# IEEE float32 reads ~1e-6 (rounding over sums of 4096 terms), TF32's
# 10-bit mantissas ~1e-3; 2e-5 lies between with room on both sides
TOL = 2e-5


@pytest.fixture(scope="module")
def gen():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (torch.cuda.is_available() is False)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.Generator(device="cuda").manual_seed(0)


def _errors(gen, shape, tf32):
    """Relative L2 errors of o, dq, dk, dv of the kernel against the
    reference in float64 on the same inputs, the inputs as q, k and v views
    of one packed (N, L, 3, H, d) tensor, as the DiT's qkv gives them."""
    n, h, length, d = shape
    qkv = torch.randn(n, length, 3, h, d, generator=gen, device="cuda")
    do = torch.randn(n, h, length, d, generator=gen, device="cuda")
    leaf = qkv.requires_grad_()
    q, k, v = (t.transpose(1, 2) for t in leaf.unbind(2))
    w = ops.KERNELS["attention"]
    launches = w.launches
    o = attention(q, k, v, tf32=tf32)
    o.backward(do)
    torch.cuda.synchronize()
    assert w.launches == launches + 1 and w.plain_calls == 0
    got = [o.detach()] + list(leaf.grad.unbind(2))
    leaf64 = qkv.detach().double().requires_grad_()
    q, k, v = (t.transpose(1, 2) for t in leaf64.unbind(2))
    o64 = softmax_attention(q, k, v, 1.0 / math.sqrt(d))
    o64.backward(do.double())
    want = [o64.detach()] + list(leaf64.grad.unbind(2))
    return [float((a.double() - b).norm() / b.norm())
            for a, b in zip(got, want)]


@pytest.mark.parametrize("shape", sorted(SHAPES))
def test_attention_matches_float64(gen, shape):
    errs = _errors(gen, SHAPES[shape], tf32=False)
    print(f"[attention {shape}] o, dq, dk, dv: {errs}")
    assert max(errs) < TOL, errs


@pytest.mark.parametrize("shape", sorted(SHAPES))
def test_attention_in_tf32_misses_the_tolerance(gen, shape):
    errs = _errors(gen, SHAPES[shape], tf32=True)
    print(f"[attention tf32 {shape}] o, dq, dk, dv: {errs}")
    assert min(errs) > TOL, errs


def test_attention_repeats_bit_for_bit(gen):
    n, h, length, d = SHAPES["global"]
    q, k, v = (torch.randn(1, h, length, d, generator=gen, device="cuda")
               for _ in range(3))
    outs = []
    for _ in range(2):
        qq, kk, vv = (t.clone().requires_grad_() for t in (q, k, v))
        o = attention(qq, kk, vv)
        o.sum().backward()
        outs.append([o.detach(), qq.grad, kk.grad, vv.grad])
    assert all(torch.equal(a, b) for a, b in zip(*outs))
