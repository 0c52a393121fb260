"""The plain reference of DiT-3D (Mo, Xie, Chu, Hong, Niessner, Li, "DiT-3D:
Exploring Plain Diffusion Transformers for 3D Shape Generation", NeurIPS
2023, arXiv:2307.01831; code github.com/DiT-3D/DiT-3D): a plain diffusion
transformer over voxel patches, in plain PyTorch, float32, with TF32 off
(`no_tf32`). It imports nothing of the measured program and no kernel:
attention is a softmax over explicit products, in query chunks
(`QUERY_CHUNK`). It is the repository's one copy of DiT-3D's equations;
the benchmark's family (`benchmark/families/dit3d.py`) and the port's CPU
tests both read it.

The forward pass, for noisy points x and timesteps t (0-based, 0..T-1):

1. Voxelize (PVCNN's `Voxelization(r, normalize=True, eps=0)`,
   DiT-3D `models/dit3d.py`): the cloud mean-centred, divided by twice its
   largest point norm, + 0.5, times r, clamped to [0, r - 1]; each point's
   features (its own coordinates) averaged into the cell of its rounded
   coordinates.
2. Patchify (`PatchEmbed_Voxel`): a Conv3d of kernel = stride = p, then
   the tokens in (x, y, z) order; plus the frozen 3-D sin-cos table
   (`get_3d_sincos_pos_embed`: D/3 channels for each axis, each axis DiT's
   1-D table, sin then cos; the grid from meshgrid(..., indexing="ij")).
3. Condition (DiT `models.py`): c = TimestepEmbedder(t) (256 sinusoidal
   frequencies, cos then sin -> Linear -> SiLU -> Linear) +
   LabelEmbedder(y) (num_classes rows plus the null row, the label
   replaced by the null row where it is dropped).
4. The DiT blocks with adaLN-Zero (`DiTBlock`): (shift, scale, gate) x 2
   = Linear(SiLU(c)); x += gate_msa * Attn(LN(x) (1 + scale_msa) +
   shift_msa); x += gate_mlp * MLP(LN(x) (1 + scale_mlp) + shift_mlp); LN
   without affine, eps 1e-6; the MLP fc1 -> GELU(tanh) -> fc2; the
   attention timm's: qkv with bias, softmax(q k^T / sqrt(d)) v, proj.
5. Window attention (`models/dit3d_window_attn.py`, ViTDet's
   non-overlapping windows in 3-D, no relative positions): in the blocks of
   `window_blocks` the modulated tokens are cut into w x w x w windows,
   which attend within themselves, and put back.
6. FinalLayer: adaLN shift / scale of LN(x), Linear D -> p^3 * 3;
   unpatchify ('nxyzpqrc->ncxpyqzr') to (B, 3, r, r, r); trilinear
   devoxelization (PVCNN) at the points: the prediction of the noise.

Training (PVD `train_generation.py`, which DiT-3D's `train.py` keeps):
a linear beta from 1e-4 to 0.02 over T steps (float64), x_t = sqrt(ab_t)
x_0 + sqrt(1 - ab_t) eps with the coefficients computed in float64 and
rounded to float32, the loss mean((eps_theta(x_t, t, y) - eps)^2), Adam.

Departures from DiT-3D and DiT, each deliberate:
- Clouds are (B, N, 3) at the interface (DiT-3D: (B, 3, N)); inside,
  the layout is DiT-3D's.
- The random draws are given by the caller: t, the noise and which labels
  are dropped (DiT-3D draws them inside `p_losses` and `token_drop`).
- The 3-D sin-cos table is a buffer outside the state dict (DiT: a frozen
  Parameter); it is computed from the formula above.
- The initializer (`init_state`) is DiT's (xavier-uniform linears and the
  patch conv viewed as a matrix, zero biases, the label table and the
  timestep MLP's weights N(0, 0.02)), except that the adaLN and final
  layers' weights are drawn N(0, 0.02) instead of zeroed: at DiT's zero
  init no gradient reaches past the last layer, and a check could not
  tell a block's gradient from none.
- The window partition needs the token grid to divide into windows
  (DiT-3D pads); 16 / 4 does.
- The voxel coordinates' mean is summed in float64 (PVCNN: in float32),
  so that a point's cell does not hang on the order of a sum.
- Blocks run under `torch.utils.checkpoint` (`checkpoint=True`), so the
  replay fits beside the weights on one card: the same function, its
  activations recomputed in the backward.
- Equations not published for the XL/2 entry, and so assumed: which
  blocks are windowed (DiT-3D publishes '0,3,6,9' for 12 blocks; the
  configuration continues the period of 3), the meshgrid order of the
  position table ("ij", as the voxel tokens are ordered), and the
  optimizer (PVD's Adam, betas (0.5, 0.999), no weight decay, no
  clipping, no EMA).
"""
from __future__ import annotations

import contextlib
import math
from typing import Callable, Dict, List

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

QUERY_CHUNK = 1024
# callables given each attention call's (q shape, k shape); the
# benchmark's work counter listens here
OBSERVERS: List[Callable] = []


@contextlib.contextmanager
def no_tf32():
    """Full float32 for cuBLAS and cuDNN inside the block; the previous
    settings come back after it."""
    flags = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = flags


# ----------------------------------------------------------- embeddings
def sincos_1d(dim: int, pos: np.ndarray) -> np.ndarray:
    """DiT's `get_1d_sincos_pos_embed_from_grid`: (M, dim), sin | cos of
    pos times 1 / 10000^(2i / dim), in float64."""
    omega = np.arange(dim // 2, dtype=np.float64) / (dim / 2.0)
    omega = 1.0 / 10000 ** omega
    out = np.einsum("m,d->md", pos.reshape(-1).astype(np.float64), omega)
    return np.concatenate([np.sin(out), np.cos(out)], axis=1)


def sincos_3d(dim: int, grid: int) -> torch.Tensor:
    """DiT-3D's `get_3d_sincos_pos_embed`: (grid^3, dim) float32, the x, y
    and z tables side by side, tokens in (x, y, z) order."""
    axis = np.arange(grid, dtype=np.float32)
    g = np.stack(np.meshgrid(axis, axis, axis, indexing="ij"), axis=0)
    emb = np.concatenate([sincos_1d(dim // 3, g[i]) for i in range(3)],
                         axis=1)
    return torch.from_numpy(emb).float()


def timestep_embedding(t: torch.Tensor, dim: int = 256,
                       max_period: float = 10000.0) -> torch.Tensor:
    """DiT's `TimestepEmbedder.timestep_embedding`: cos | sin of t times
    exp(-ln(max_period) i / half)."""
    half = dim // 2
    freqs = torch.exp(-math.log(max_period) * torch.arange(
        half, dtype=torch.float32, device=t.device) / half)
    args = t[:, None].float() * freqs[None]
    return torch.cat([torch.cos(args), torch.sin(args)], dim=-1)


# ------------------------------------------------------------ voxels
def normalize_coords(x: torch.Tensor, r: int) -> torch.Tensor:
    """PVCNN's Voxelization with normalize=True, eps=0: (B, N, 3) ->
    continuous voxel coordinates in [0, r - 1]. The mean is summed in
    float64 and each norm op by op, so that a point's cell does not hang on
    the order of a sum (a departure in rounding only)."""
    x = x.detach().float()
    c = x - x.double().mean(dim=1, keepdim=True).float()
    norm = torch.sqrt(c[..., 0] * c[..., 0] + c[..., 1] * c[..., 1]
                      + c[..., 2] * c[..., 2])[..., None]
    return torch.clamp((c / (norm.amax(dim=1, keepdim=True) * 2.0) + 0.5) * r,
                       0, r - 1)


def avg_voxelize(features: torch.Tensor, norm_coords: torch.Tensor,
                 r: int) -> torch.Tensor:
    """features (B, C, N) averaged into the cells of the rounded
    coordinates -> (B, C, r, r, r); empty cells 0."""
    b, c, n = features.shape
    v = torch.round(norm_coords).long()
    flat = (v[..., 0] * r + v[..., 1]) * r + v[..., 2]
    sums = torch.zeros(b, c, r ** 3, device=features.device).scatter_add(
        2, flat[:, None, :].expand(b, c, n), features)
    count = torch.zeros(b, 1, r ** 3, device=features.device).scatter_add(
        2, flat[:, None, :], torch.ones(b, 1, n, device=features.device))
    return (sums / count.clamp_min(1.0)).reshape(b, c, r, r, r)


def trilinear_devoxelize(grid: torch.Tensor, norm_coords: torch.Tensor,
                         r: int) -> torch.Tensor:
    """PVCNN's trilinear devoxelization: grid (B, C, r, r, r) at the
    continuous coordinates (B, N, 3) -> (B, C, N); the upper corner of an
    axis is the lower one where the coordinate is integral."""
    b, c = grid.shape[:2]
    flat_grid = grid.reshape(b, c, r ** 3)
    lo = torch.floor(norm_coords)
    frac = norm_coords - lo
    lo = lo.long()
    hi = lo + (frac > 0).long()
    out = 0
    for dx in (0, 1):
        for dy in (0, 1):
            for dz in (0, 1):
                w = torch.ones_like(frac[..., 0])
                idx = torch.zeros_like(lo[..., 0])
                for axis, pick in enumerate((dx, dy, dz)):
                    f = frac[..., axis]
                    w = w * (f if pick else 1.0 - f)
                    idx = idx * r + (hi if pick else lo)[..., axis]
                vals = torch.gather(flat_grid, 2,
                                    idx[:, None, :].expand(b, c, -1))
                out = out + vals * w[:, None, :]
    return out


# ------------------------------------------------------------- blocks
def softmax_attention(q, k, v, scale: float) -> torch.Tensor:
    """softmax(q k^T scale) v over (N, H, L, d), QUERY_CHUNK queries at a
    time."""
    for observe in OBSERVERS:
        observe(tuple(q.shape), tuple(k.shape))
    outs = [torch.softmax(torch.matmul(q[:, :, i:i + QUERY_CHUNK],
                                       k.transpose(-2, -1)) * scale, dim=-1)
            @ v for i in range(0, q.shape[2], QUERY_CHUNK)]
    return torch.cat(outs, dim=2)


class Attention(nn.Module):
    def __init__(self, dim: int, heads: int):
        super().__init__()
        self.heads = heads
        self.qkv = nn.Linear(dim, 3 * dim)
        self.proj = nn.Linear(dim, dim)

    def forward(self, x):
        n, length, c = x.shape
        d = c // self.heads
        qkv = self.qkv(x).reshape(n, length, 3, self.heads, d)
        q, k, v = qkv.permute(2, 0, 3, 1, 4).unbind(0)
        o = softmax_attention(q, k, v, d ** -0.5)
        return self.proj(o.transpose(1, 2).reshape(n, length, c))


class Mlp(nn.Module):
    def __init__(self, dim: int, hidden: int):
        super().__init__()
        self.fc1 = nn.Linear(dim, hidden)
        self.fc2 = nn.Linear(hidden, dim)

    def forward(self, x):
        return self.fc2(F.gelu(self.fc1(x), approximate="tanh"))


def modulate(x, shift, scale):
    return x * (1 + scale[:, None]) + shift[:, None]


def window_partition(x: torch.Tensor, grid: int, w: int) -> torch.Tensor:
    """(B, grid^3, C) tokens in (x, y, z) order -> (B (grid / w)^3, w^3, C)
    windows (ViTDet's `window_partition` in 3-D)."""
    b, _, c = x.shape
    n = grid // w
    x = x.reshape(b, n, w, n, w, n, w, c).permute(0, 1, 3, 5, 2, 4, 6, 7)
    return x.reshape(b * n ** 3, w ** 3, c)


def window_unpartition(x: torch.Tensor, grid: int, w: int) -> torch.Tensor:
    """The inverse of `window_partition`."""
    n = grid // w
    c = x.shape[-1]
    b = x.shape[0] // n ** 3
    x = x.reshape(b, n, n, n, w, w, w, c).permute(0, 1, 4, 2, 5, 3, 6, 7)
    return x.reshape(b, grid ** 3, c)


class DiTBlock(nn.Module):
    def __init__(self, dim: int, heads: int, mlp_ratio: float, grid: int,
                 window: int):
        super().__init__()
        self.grid, self.window = grid, window
        self.attn = Attention(dim, heads)
        self.mlp = Mlp(dim, int(dim * mlp_ratio))
        self.adaLN_modulation = nn.Sequential(nn.SiLU(),
                                              nn.Linear(dim, 6 * dim))

    def forward(self, x, c):
        (shift_msa, scale_msa, gate_msa, shift_mlp, scale_mlp,
         gate_mlp) = self.adaLN_modulation(c).chunk(6, dim=1)
        h = modulate(F.layer_norm(x, x.shape[-1:], eps=1e-6), shift_msa,
                     scale_msa)
        if self.window:
            h = window_unpartition(self.attn(window_partition(
                h, self.grid, self.window)), self.grid, self.window)
        else:
            h = self.attn(h)
        x = x + gate_msa[:, None] * h
        h = modulate(F.layer_norm(x, x.shape[-1:], eps=1e-6), shift_mlp,
                     scale_mlp)
        return x + gate_mlp[:, None] * self.mlp(h)


class FinalLayer(nn.Module):
    def __init__(self, dim: int, out: int):
        super().__init__()
        self.linear = nn.Linear(dim, out)
        self.adaLN_modulation = nn.Sequential(nn.SiLU(),
                                              nn.Linear(dim, 2 * dim))

    def forward(self, x, c):
        shift, scale = self.adaLN_modulation(c).chunk(2, dim=1)
        return self.linear(modulate(
            F.layer_norm(x, x.shape[-1:], eps=1e-6), shift, scale))


class TimestepEmbedder(nn.Module):
    def __init__(self, dim: int, freq: int):
        super().__init__()
        self.freq = freq
        self.mlp = nn.Sequential(nn.Linear(freq, dim), nn.SiLU(),
                                 nn.Linear(dim, dim))

    def forward(self, t):
        return self.mlp(timestep_embedding(t, self.freq))


class LabelEmbedder(nn.Module):
    def __init__(self, classes: int, dim: int):
        super().__init__()
        self.classes = classes
        self.embedding_table = nn.Embedding(classes + 1, dim)

    def forward(self, y, drop=None):
        if drop is not None:
            y = torch.where(drop, self.classes, y)
        return self.embedding_table(y)


class PatchEmbed(nn.Module):
    def __init__(self, p: int, dim: int):
        super().__init__()
        self.proj = nn.Conv3d(3, dim, kernel_size=p, stride=p)

    def forward(self, grid):
        return self.proj(grid).flatten(2).transpose(1, 2)


class DiT3D(nn.Module):
    """The model of `cfg["dit3d"]`: forward(x (B, N, 3), t (B,), y (B,),
    drop (B,) bool or None) -> the predicted noise (B, N, 3)."""

    def __init__(self, cfg: dict, checkpoint_blocks: bool = True):
        super().__init__()
        m = cfg["dit3d"]
        d, p, r = m["hidden_size"], m["patch_size"], m["voxel_size"]
        self.r, self.p, self.grid = r, p, r // p
        self.checkpoint_blocks = checkpoint_blocks
        windowed = set(m["window_blocks"])
        self.x_embedder = PatchEmbed(p, d)
        self.t_embedder = TimestepEmbedder(d, m["frequency_embedding_size"])
        self.y_embedder = LabelEmbedder(m["num_classes"], d)
        self.register_buffer("pos_embed", sincos_3d(d, self.grid)[None].to(
            self.x_embedder.proj.weight.device), persistent=False)
        self.blocks = nn.ModuleList(
            DiTBlock(d, m["num_heads"], m["mlp_ratio"], self.grid,
                     m["window_size"] if i in windowed else 0)
            for i in range(m["depth"]))
        self.final_layer = FinalLayer(d, p ** 3 * 3)

    def unpatchify(self, x):
        """(B, T, p^3 3) -> (B, 3, r, r, r), 'nxyzpqrc->ncxpyqzr'."""
        g, p = self.grid, self.p
        x = x.reshape(x.shape[0], g, g, g, p, p, p, 3)
        x = torch.einsum("nxyzpqrc->ncxpyqzr", x)
        return x.reshape(x.shape[0], 3, self.r, self.r, self.r)

    def forward(self, x, t, y, drop=None):
        coords = normalize_coords(x, self.r)
        grid = avg_voxelize(x.transpose(1, 2), coords, self.r)
        h = self.x_embedder(grid) + self.pos_embed
        c = self.t_embedder(t) + self.y_embedder(y, drop)
        for block in self.blocks:
            if self.checkpoint_blocks and torch.is_grad_enabled():
                h = checkpoint(block, h, c, use_reentrant=False)
            else:
                h = block(h, c)
        out = self.unpatchify(self.final_layer(h, c))
        return trilinear_devoxelize(out, coords, self.r).transpose(1, 2)


# ------------------------------------------------------------ weights
def init_kinds(model: DiT3D) -> Dict[str, str]:
    """name -> how `init_state` draws it: "xavier", "normal" or "zeros"."""
    kinds = {}
    for name, _ in model.named_parameters():
        if name.endswith("bias"):
            kinds[name] = "zeros"
        elif name.startswith(("y_embedder", "t_embedder")) \
                or "adaLN_modulation" in name \
                or name.startswith("final_layer.linear"):
            kinds[name] = "normal"
        else:
            kinds[name] = "xavier"
    return kinds


def init_state(cfg: dict, generator: torch.Generator,
               device) -> Dict[str, torch.Tensor]:
    """The state dict drawn from `generator` on `device`, tensor by tensor
    in the model's parameter order: xavier-uniform (a weight viewed as
    (out, in)), N(0, 0.02) or zeros (`init_kinds`)."""
    with torch.device("meta"):
        model = DiT3D(cfg)
    shapes = {name: p.shape for name, p in model.named_parameters()}
    state = {}
    for name, kind in init_kinds(model).items():
        shape = shapes[name]
        if kind == "zeros":
            state[name] = torch.zeros(shape, device=device)
        elif kind == "normal":
            state[name] = 0.02 * torch.randn(shape, generator=generator,
                                              device=device)
        else:
            fan_out, fan_in = shape[0], math.prod(shape[1:])
            a = math.sqrt(6.0 / (fan_in + fan_out))
            state[name] = (torch.rand(shape, generator=generator,
                                      device=device) * 2.0 - 1.0) * a
    return state


# ---------------------------------------------------------- diffusion
class Schedule:
    """PVD's linear betas over T steps (float64)."""

    def __init__(self, cfg: dict):
        ddpm = cfg["ddpm"]
        if ddpm["sched_mode"] != "linear":
            raise NotImplementedError(ddpm["sched_mode"])
        self.steps = int(ddpm["num_steps"])
        betas = np.linspace(ddpm["beta_1"], ddpm["beta_T"], self.steps,
                            dtype=np.float64)
        self.ab64 = np.cumprod(1.0 - betas)
        self.sqrt_ab = torch.from_numpy(np.sqrt(self.ab64)).float()
        self.sqrt_1m_ab = torch.from_numpy(np.sqrt(1.0 - self.ab64)).float()

    def q_sample(self, x0, t, noise):
        """sqrt(ab_t) x0 + sqrt(1 - ab_t) noise (PVD's `q_sample`)."""
        a = self.sqrt_ab.to(x0.device)[t.long()][:, None, None]
        s = self.sqrt_1m_ab.to(x0.device)[t.long()][:, None, None]
        return a * x0 + s * noise

    def ddim(self, ddim_step: int, kappa: float = 1.0):
        """[(t, scale, c, sigma)] per DDIM step (uniform skips, t
        descending to 0, the port's sampler's schedule of the float32
        alpha_bars): x <- scale x + c eps + sigma noise."""
        ab = self.ab64.astype(np.float32).astype(np.float64)
        step = (self.steps - 1.0) / (ddim_step - 1.0)
        taus = sorted((int(np.floor(i * step)) for i in range(ddim_step)),
                      reverse=True)
        out = []
        for i, t in enumerate(taus):
            last = i == len(taus) - 1
            a_next = 1.0 if last else ab[taus[i + 1]]
            sigma = 0.0 if last else kappa * np.sqrt(
                (1 - a_next) / (1 - ab[t]) * (1 - ab[t] / a_next))
            scale = np.sqrt(a_next / ab[t])
            c = np.sqrt(max(1 - a_next - sigma * sigma, 0.0)) \
                - np.sqrt(1 - ab[t]) * scale
            out.append((t, float(scale), float(c), float(sigma)))
        return out


def loss(model: DiT3D, sched: Schedule, x0, t, noise, y, drop):
    """PVD's objective on given draws: mean((eps_theta(x_t) - noise)^2)."""
    eps = model(sched.q_sample(x0, t, noise), t, y, drop)
    return ((eps - noise) ** 2).mean()


@torch.no_grad()
def ddim_sample(model: DiT3D, sched: Schedule, num: int, points: int,
                ddim_step: int, generator: torch.Generator, y,
                kappa: float = 1.0) -> torch.Tensor:
    """DDIM from x_T drawn with `generator`, the model at each step's t,
    the noise of each step's update drawn after it."""
    x = torch.randn(num, points, 3, generator=generator,
                    device=generator.device)
    for t, scale, c, sigma in sched.ddim(ddim_step, kappa):
        tt = torch.full((num,), float(t), device=x.device)
        x = scale * x + c * model(x, tt, y)
        if sigma:
            x = x + sigma * torch.randn(x.shape, generator=generator,
                                        device=x.device)
    return x


class Adam:
    """m <- b1 m + (1 - b1) g; v <- b2 v + (1 - b2) g^2;
    p <- p - lr / (1 - b1^k) m / (sqrt(v) / sqrt(1 - b2^k) + eps)."""

    def __init__(self, params, lr, beta1, beta2, eps=1e-8):
        self.params = list(params)
        self.lr, self.b1, self.b2, self.eps = lr, beta1, beta2, eps
        self.m = [torch.zeros_like(p) for p in self.params]
        self.v = [torch.zeros_like(p) for p in self.params]
        self.k = 0

    @torch.no_grad()
    def step(self, grads):
        self.k += 1
        bc1, bc2 = 1 - self.b1 ** self.k, 1 - self.b2 ** self.k
        for p, g, m, v in zip(self.params, grads, self.m, self.v):
            m.mul_(self.b1).add_(g, alpha=1 - self.b1)
            v.mul_(self.b2).addcmul_(g, g, value=1 - self.b2)
            p.sub_(self.lr / bc1 * m / (v.sqrt() / bc2 ** 0.5 + self.eps))


def work_of(cfg: dict, mix: dict, device):
    """One training step's forward and backward on the reference built on
    `device` (uninitialized weights, zero inputs), its blocks not
    checkpointed, so the counters see one forward and one backward."""
    with torch.device(device):
        model = DiT3D(cfg, checkpoint_blocks=False)
    b, n = mix["batch"], cfg["data"]["tr_max_sample_points"]
    sched = Schedule(cfg)

    def train():
        x = torch.zeros(b, n, 3, device=device)
        t = torch.zeros(b, dtype=torch.long, device=device)
        y = torch.zeros(b, dtype=torch.long, device=device)
        loss(model, sched, x, t, x, y, None).backward()

    return train
