"""The LION model in plain PyTorch, float32: the VAE (style encoder,
latent-points encoder, decoder), the global prior (the 'se_drop' blocks of
PriorSEDrop or the 'se_clip' blocks of PriorSEClip) and the local prior
(the AdaGN PVCNN2 U-Net), after nv-tlabs/LION's models/ (vae_adain.py,
latent_points_ada.py, latent_points_ada_localprior.py, pvcnn2_ada.py,
score_sde/resnet.py).

Each module names its parameters as the measured program does (flax's
layouts: dense kernels (in, out), conv kernels (3, 3, 3, in, out)), so one
state dict made by the benchmark loads into both. Every module states how
its parameters start (`init_spec`), which `benchmark.weights` draws from
the seed. One flow serves evaluation and training: the module's mode
switches its dropout, which draws its masks from a generator the caller
sets (`set_generator`), in the order the forward pass meets them.

Reads the configuration as a plain nested dict (the `cfg` of a
configuration file of the benchmark); `tpu.sa_blocks` / `tpu.fp_blocks`,
`tpu.vres_mult` and `tpu.ncenter_mult` resize the U-Nets for the CPU tests.
"""
from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from . import ops

GN_GROUPS, GN_EPS = 8, 1e-5


def swish(x):
    return x * torch.sigmoid(x)


class Dense(nn.Module):
    def __init__(self, out: int, fan_in: int, bias: bool = True):
        super().__init__()
        self.kernel = nn.Parameter(torch.empty(fan_in, out))
        self.bias = nn.Parameter(torch.empty(out)) if bias else None

    def init_spec(self):
        bound = 1.0 / math.sqrt(self.kernel.shape[0])
        spec = {"kernel": ("uniform", bound)}
        if self.bias is not None:
            spec["bias"] = ("uniform", bound)
        return spec

    def forward(self, x):
        y = x @ self.kernel
        return y if self.bias is None else y + self.bias


class StyleDense(Dense):
    """AdaGN's style projection: a fan-average uniform kernel and the bias
    (1, ..., 1, 0, ..., 0), so the norm starts unscaled."""

    def __init__(self, n: int, style_dim: int, init_scale: float):
        super().__init__(2 * n, style_dim)
        self.n = n
        self.init_scale = 1e-10 if init_scale == 0 else init_scale

    def init_spec(self):
        fan_avg = (self.kernel.shape[0] + self.kernel.shape[1]) / 2.0
        return {"kernel": ("uniform", math.sqrt(3.0 * self.init_scale
                                                / fan_avg)),
                "bias": ("ones_then_zeros", self.n)}


class Conv3d(nn.Module):
    def __init__(self, out: int, cin: int):
        super().__init__()
        self.kernel = nn.Parameter(torch.empty(3, 3, 3, cin, out))
        self.bias = nn.Parameter(torch.empty(out))

    def init_spec(self):
        bound = 1.0 / math.sqrt(27 * self.kernel.shape[3])
        return {"kernel": ("uniform", bound), "bias": ("uniform", bound)}

    def forward(self, x):
        return ops.conv3d(x, self.kernel) + self.bias


class GNAffine(nn.Module):
    def __init__(self, c: int):
        super().__init__()
        self.scale = nn.Parameter(torch.empty(c))
        self.bias = nn.Parameter(torch.empty(c))

    def init_spec(self):
        return {"scale": ("const", 1.0), "bias": ("const", 0.0)}


def group_norm(x, scale, bias, groups: int = GN_GROUPS, eps: float = GN_EPS):
    """GroupNorm over all but the batch and channel axes, var = E[x^2] -
    E[x]^2 (clamped at 0), the two means summed in float64."""
    b, c = x.shape[0], x.shape[-1]
    xg = x.reshape(b, -1, groups, c // groups)
    mean = xg.mean(dim=(1, 3), keepdim=True, dtype=torch.float64)
    var = torch.clamp_min((xg * xg).mean(dim=(1, 3), keepdim=True,
                                         dtype=torch.float64) - mean * mean,
                          0.0)
    y = (xg - mean.float()) * torch.rsqrt(var.float() + eps)
    return y.reshape(x.shape) * scale + bias


class Norm(nn.Module):
    """GroupNorm(8), or AdaGN: GroupNorm(8) then a per-channel (factor,
    bias) projected from the style."""

    def __init__(self, c: int, ada: bool, style_dim: int, init_scale: float):
        super().__init__()
        self.is_ada = ada
        if ada:
            self.ada = nn.Module()
            self.ada.emd = StyleDense(c, style_dim, init_scale)
            self.ada.norm = GNAffine(c)
        else:
            self.gn = GNAffine(c)
        self.c = c

    def forward(self, x, style=None):
        if not self.is_ada:
            return group_norm(x, self.gn.scale, self.gn.bias)
        s = self.ada.emd(style)
        y = group_norm(x, self.ada.norm.scale, self.ada.norm.bias)
        shape = (x.shape[0],) + (1,) * (x.ndim - 2) + (self.c,)
        return y * s[:, :self.c].reshape(shape) + s[:, self.c:].reshape(shape)


class Dropout(nn.Module):
    """Keep with probability 1 - p, scaled by 1 / (1 - p); the mask is
    torch.rand(shape) < 1 - p from the generator `set_generator` gave."""

    def __init__(self, p: float):
        super().__init__()
        self.p = float(p)
        self.generator = None

    def forward(self, x):
        if not self.training or self.p == 0.0:
            return x
        keep = 1.0 - self.p
        mask = torch.rand(x.shape, generator=self.generator,
                          device=x.device) < keep
        return torch.where(mask, x / keep, torch.zeros_like(x))


def set_generator(module: nn.Module, generator) -> None:
    for m in module.modules():
        if isinstance(m, Dropout):
            m.generator = generator


class SE(nn.Module):
    def __init__(self, c: int):
        super().__init__()
        self.fc1 = Dense(c // 8, c, bias=False)
        self.fc2 = Dense(c, c // 8, bias=False)

    def forward(self, x):
        g = torch.sigmoid(self.fc2(torch.relu(self.fc1(
            x.mean(dim=tuple(range(1, x.ndim - 1)))))))
        return x * g.reshape((x.shape[0],) + (1,) * (x.ndim - 2)
                             + (x.shape[-1],))


class Attention(nn.Module):
    """Linear attention over the points: softmax over the points of k,
    heads of 32."""

    def __init__(self, dim: int, heads: int = 4):
        super().__init__()
        self.heads = heads
        self.to_qkv = Dense(heads * 32 * 3, dim, bias=False)
        self.to_out = Dense(dim, heads * 32)

    def forward(self, x):
        b, n, _ = x.shape
        qkv = self.to_qkv(x).reshape(b, n, 3, self.heads, 32)
        q, k, v = qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]
        k = torch.softmax(k, dim=1)
        ctx = torch.einsum("bnhd,bnhe->bhde", k, v)
        out = torch.einsum("bhde,bnhd->bnhe", ctx, q)
        return self.to_out(out.reshape(b, n, self.heads * 32))


class MLP(nn.Module):
    """Per-point [dense -> (Ada)GN -> swish] layers."""

    def __init__(self, cin: int, outs, ada=False, style_dim=128,
                 init_scale=1.0):
        super().__init__()
        self.depth = len(outs)
        for i, oc in enumerate(outs):
            self.add_module(f"conv{i}", Dense(oc, cin))
            self.add_module(f"norm{i}", Norm(oc, ada, style_dim, init_scale))
            cin = oc
        self.out_channels = cin

    def forward(self, x, style=None):
        for i in range(self.depth):
            x = swish(getattr(self, f"norm{i}")(getattr(self, f"conv{i}")(x),
                                                style))
        return x


class PVConv(nn.Module):
    """voxelize -> conv -> norm -> swish -> dropout -> conv -> norm -> SE ->
    devoxelize, plus the per-point MLP, then optional attention."""

    def __init__(self, cin, cout, r, attention=False, ada=False,
                 style_dim=128, init_scale=1.0, dropout=0.1):
        super().__init__()
        self.r = r
        self.drop = Dropout(dropout)
        self.vconv0 = Conv3d(cout, cin)
        self.vnorm0 = Norm(cout, ada, style_dim, init_scale)
        self.vconv1 = Conv3d(cout, cout)
        self.vnorm1 = Norm(cout, ada, style_dim, init_scale)
        self.se = SE(cout)
        self.point_features = MLP(cin, (cout,), ada, style_dim, init_scale)
        self.attn = Attention(cout) if attention else None

    def forward(self, features, coords, style=None):
        grid, nc = ops.voxelize(features, coords[..., :3], self.r)
        h = swish(self.vnorm0(self.vconv0(grid), style))
        h = self.se(self.vnorm1(self.vconv1(self.drop(h)), style))
        out = ops.devoxelize(h, nc, self.r) \
            + self.point_features(features, style)
        return out if self.attn is None else self.attn(out)


def _branches(outs):
    if not isinstance(outs[0], (list, tuple)):
        return (tuple(outs),)
    return tuple(tuple(b) for b in outs)


class SAModule(nn.Module):
    """FPS, ball grouping, MLP, max over the neighbours; or, without
    centers, MLP over all points and a global max."""

    def __init__(self, centers, radius, k, cin, outs, ada=False,
                 style_dim=128, init_scale=1.0):
        super().__init__()
        self.centers = centers
        self.radius = list(radius) if isinstance(radius, (list, tuple)) \
            else [radius]
        self.k = list(k) if isinstance(k, (list, tuple)) \
            else [k] * len(self.radius)
        branches = _branches(outs)
        if len(branches) == 1 and len(self.radius) > 1:
            branches = branches * len(self.radius)
        self.n_branch = len(branches)
        for i, br in enumerate(branches):
            self.add_module(f"mlp{i}", MLP(cin + 3, br, ada, style_dim,
                                           init_scale))
        self.out_channels = sum(br[-1] for br in branches)

    def forward(self, features, coords, style=None):
        xyz = coords[..., :3]
        if self.centers is None:
            x = torch.cat([features, xyz], dim=-1)
            out = torch.cat([getattr(self, f"mlp{i}")(x, style).amax(
                dim=1, keepdim=True) for i in range(self.n_branch)], dim=-1)
            return out, coords.new_zeros((coords.shape[0], 1, 3))
        centers = ops.furthest_point_sample(xyz, self.centers)
        outs = [getattr(self, f"mlp{i}")(ops.ball_group(
            xyz, centers, features, r, k), style).amax(dim=2)
            for i, (r, k) in enumerate(zip(self.radius, self.k))]
        return torch.cat(outs, dim=-1), centers


class FPModule(nn.Module):
    def __init__(self, cin, outs, ada=False, style_dim=128, init_scale=1.0):
        super().__init__()
        self.mlp = MLP(cin, tuple(outs), ada, style_dim, init_scale)
        self.out_channels = self.mlp.out_channels

    def forward(self, points, centers, centers_features, points_features,
                style=None):
        x = ops.three_nn_interpolate(points[..., :3], centers[..., :3],
                                     centers_features)
        if points_features is not None:
            x = torch.cat([x, points_features], dim=-1)
        return self.mlp(x, style)


def timestep_embedding(t, dim: int, scale: float = 1.0):
    t = t.float() * scale
    half = dim // 2
    step = float(-np.log(np.float32(10000.0)) / np.float32(half - 1))
    freqs = torch.exp(torch.arange(half, dtype=torch.float32,
                                   device=t.device) * step)
    args = t[:, None] * freqs[None, :]
    emb = torch.cat([torch.sin(args), torch.cos(args)], dim=-1)
    return F.pad(emb, (0, 1)) if dim % 2 else emb


def sa_specs(sa_blocks, extra, input_dim, vres_mult, ncenter_mult):
    """Per SA stage: ([(out, r, attention)], (centers, radius, k, outs) or
    None), and the last stage's width. Stages after the first build one
    conv block whatever their count; attention at odd stages."""
    cin = extra + input_dim
    stages = []
    for c, (conv, sa) in enumerate(sa_blocks):
        convs = []
        if conv is not None:
            out, nblocks, r = conv
            for p in range(nblocks):
                if c == 0 or p == 0:
                    convs.append((out, None if r is None else
                                  max(int(r * vres_mult), 2),
                                  (c + 1) % 2 == 0 and p == 0))
                cin = out
        s = None
        if sa is not None:
            nc, radius, k, outs = sa
            if nc is not None:
                nc = max(int(nc * ncenter_mult), 1)
            s = (nc, radius, k, outs)
            cin = sum(b[-1] for b in _branches(outs))
        stages.append((convs, s))
    return stages, cin


class Unet(nn.Module):
    """PVCNN2: SA stages, global attention, FP stages, classifier head,
    with the time embedding joined to the features at SA stages after the
    first and at every FP input, and the style (mapped with CLIP features
    when `clip`) in every AdaGN."""

    def __init__(self, out, sa_blocks, fp_blocks, embed_dim=0, extra=3,
                 input_dim=3, temb_scale=1.0, style_dim=128, init_scale=1.0,
                 vres_mult=1.0, ncenter_mult=1.0, dropout=0.1, clip=False,
                 clip_dim=512):
        super().__init__()
        self.input_dim, self.embed_dim = input_dim, embed_dim
        self.temb_scale = temb_scale
        kw = dict(ada=True, style_dim=style_dim, init_scale=init_scale)
        if embed_dim > 0:
            self.embedf0 = Dense(embed_dim, embed_dim)
            self.embedf1 = Dense(embed_dim, embed_dim)
        self.clip_forge_mapping = self.style_clip = None
        if clip:
            self.clip_forge_mapping = Dense(embed_dim, clip_dim)
            self.style_clip = Dense(style_dim, style_dim + embed_dim)
        self.sa, width = sa_specs(sa_blocks, extra, input_dim, vres_mult,
                                  ncenter_mult)
        c = input_dim + extra
        skips = []
        for i, (convs, s) in enumerate(self.sa):
            skips.append(c)
            if i > 0:
                c += embed_dim
            for j, (oc, r, att) in enumerate(convs):
                self.add_module(f"sa{i}_conv{j}",
                                self._conv(c, oc, r, att, dropout, kw))
                c = oc
            if s is not None:
                mod = SAModule(s[0], s[1], s[2], c, s[3], **kw)
                self.add_module(f"sa{i}_sa", mod)
                c = mod.out_channels
        skips[0] = extra + input_dim - 3
        self.global_att = Attention(width, heads=8)
        self.fp = []
        for f, (fp_out, conv) in enumerate(fp_blocks):
            mod = FPModule(c + embed_dim + skips[-1 - f], fp_out, **kw)
            self.add_module(f"fp{f}_fp", mod)
            c = mod.out_channels
            n = 0
            if conv is not None:
                oc, n, r = conv
                r = None if r is None else max(int(r * vres_mult), 2)
                for j in range(n):
                    self.add_module(f"fp{f}_conv{j}",
                                    self._conv(c, oc, r, False, dropout, kw))
                    c = oc
            self.fp.append(n)
        self.cls_mlp = MLP(c, (128,), **kw)
        self.cls_drop = Dropout(dropout)
        self.cls_out = Dense(out, 128)

    @staticmethod
    def _conv(cin, oc, r, att, dropout, kw):
        if r is None:
            return MLP(cin, (oc,), **kw)
        return PVConv(cin, oc, r, att, dropout=dropout, **kw)

    def _run(self, name, feats, coords, style):
        mod = getattr(self, name)
        return mod(feats, coords, style) if isinstance(mod, PVConv) \
            else mod(feats, style)

    def forward(self, inputs, t=None, style=None, clip_feat=None):
        b = inputs.shape[0]
        coords, feats = inputs[..., :self.input_dim], inputs
        temb = None
        if t is not None and self.embed_dim > 0:
            t = torch.as_tensor(t, dtype=torch.float32,
                                device=inputs.device).reshape(-1).expand(b)
            emb = timestep_embedding(t, self.embed_dim, self.temb_scale)
            temb = self.embedf1(F.leaky_relu(self.embedf0(emb), 0.1))
        if self.style_clip is not None:
            style = self.style_clip(torch.cat(
                [style, self.clip_forge_mapping(clip_feat)], dim=-1))

        def with_temb(x):
            if temb is None:
                return x
            return torch.cat([x, temb[:, None, :].expand(-1, x.shape[1], -1)],
                             dim=-1)

        coords_list, feats_list = [], []
        for i, (convs, s) in enumerate(self.sa):
            feats_list.append(feats)
            coords_list.append(coords)
            if i > 0:
                feats = with_temb(feats)
            for j in range(len(convs)):
                feats = self._run(f"sa{i}_conv{j}", feats, coords, style)
            if s is not None:
                feats, coords = getattr(self, f"sa{i}_sa")(feats, coords,
                                                           style)
        extra = inputs[..., 3:]
        feats_list[0] = extra if extra.shape[-1] > 0 else None
        feats = self.global_att(feats)
        for f, n in enumerate(self.fp):
            target = coords_list[-1 - f]
            feats = getattr(self, f"fp{f}_fp")(target, coords,
                                               with_temb(feats),
                                               feats_list[-1 - f], style)
            coords = target
            for j in range(n):
                feats = self._run(f"fp{f}_conv{j}", feats, coords, style)
        return self.cls_out(self.cls_drop(self.cls_mlp(feats, style)))


# The released U-Net specs (latent_points_ada.py:177-188,
# latent_points_ada_localprior.py:17-28, shapelatent_modules.py:14-17).
VAE_SA = (((32, 2, 32), (1024, 0.1, 32, (32, 64))),
          ((64, 3, 16), (256, 0.2, 32, (64, 128))),
          ((128, 3, 8), (64, 0.4, 32, (128, 256))),
          (None, (16, 0.8, 32, (128, 128, 128))))
PRIOR_SA = VAE_SA[:2] + (((128, 3, 8), (64, 0.4, 32, (128, 128))),) \
    + VAE_SA[3:]
FP = (((128, 128), (128, 3, 8)), ((128, 128), (128, 3, 8)),
      ((128, 128), (128, 2, 16)), ((128, 128, 64), (64, 2, 32)))
STYLE_SA = (((32, 2, 32), (1024, 0.1, 32, (32, 32))),
            ((32, 1, 16), (256, 0.2, 32, (32, 64))))


def _specs(cfg, sa_default):
    tpu = cfg.get("tpu", {})
    sa = tpu.get("sa_blocks") or sa_default
    fp = tpu.get("fp_blocks") or FP
    return sa, fp, tpu.get("vres_mult", 1.0), tpu.get("ncenter_mult", 1.0)


class StyleEncoder(nn.Module):
    """Two plain SA stages, a max over the points, a dense layer to
    (mu, log_sigma) of the style."""

    def __init__(self, zdim, input_dim, dropout, vres_mult, ncenter_mult):
        super().__init__()
        self.zdim = zdim
        self.stages, width = sa_specs(STYLE_SA, 0, input_dim, vres_mult,
                                      ncenter_mult)
        c = input_dim
        for i, (convs, s) in enumerate(self.stages):
            for j, (oc, r, att) in enumerate(convs):
                self.add_module(f"sa{i}_conv{j}", PVConv(c, oc, r, att,
                                                         dropout=dropout))
                c = oc
            mod = SAModule(s[0], s[1], s[2], c, s[3])
            self.add_module(f"sa{i}_sa", mod)
            c = mod.out_channels
        self.mlp = Dense(zdim * 2, width)

    def forward(self, x):
        feats, coords = x, x
        for i, (convs, _) in enumerate(self.stages):
            for j in range(len(convs)):
                feats = getattr(self, f"sa{i}_conv{j}")(feats, coords)
            feats, coords = getattr(self, f"sa{i}_sa")(feats, coords)
        out = self.mlp(feats.amax(dim=1))
        return out[:, :self.zdim], out[:, self.zdim:]


class VAE(nn.Module):
    """Style encoder, latent-points encoder (`encoder.layers`) and decoder
    (`decoder.layers`), the released unconditional hierarchy."""

    def __init__(self, cfg):
        super().__init__()
        lp, sl, ddpm = cfg["latent_pts"], cfg["shapelatent"], cfg["ddpm"]
        sa, fp, vres, ncent = _specs(cfg, VAE_SA)
        self.input_dim, self.latent_dim = ddpm["input_dim"], sl["latent_dim"]
        self.num_points = cfg["data"]["tr_max_sample_points"]
        self.style_dim = lp["style_dim"]
        self.skip_weight = lp["skip_weight"]
        self.pts_sigma_offset = lp["pts_sigma_offset"]
        self.log_sigma_offset = sl["log_sigma_offset"]
        self.style_encoder = StyleEncoder(self.style_dim, self.input_dim,
                                          ddpm["dropout"], vres, ncent)
        d, z = self.input_dim, self.latent_dim
        unet = dict(sa_blocks=sa, fp_blocks=fp, embed_dim=0, input_dim=d,
                    style_dim=self.style_dim,
                    init_scale=lp["ada_mlp_init_scale"], vres_mult=vres,
                    ncenter_mult=ncent, dropout=ddpm["dropout"])
        self.encoder = nn.Module()
        self.encoder.layers = Unet(2 * z + 2 * d, extra=0, **unet)
        self.decoder = nn.Module()
        self.decoder.layers = Unet(d, extra=z, **unet)

    def encode(self, x, generator):
        """-> (z_global, mu_g, log_sigma_g, z_local, mu_l, log_sigma_l),
        the two standard normals drawn from `generator` in that order."""
        b, d, z = x.shape[0], self.input_dim, self.latent_dim
        mu_g, ls_g = self.style_encoder(x)
        z_g = torch.randn(mu_g.shape, generator=generator,
                          device=x.device) * torch.exp(ls_g) + mu_g
        out = self.encoder.layers(x, style=z_g)
        pt_mu = self.skip_weight * out[..., :d] + x
        pt_sigma = out[..., d:2 * d] - self.pts_sigma_offset
        mu = torch.cat([pt_mu, out[..., 2 * d:-z]], dim=-1).reshape(b, -1)
        ls = torch.cat([pt_sigma, out[..., -z:]], dim=-1).reshape(b, -1) \
            - self.log_sigma_offset
        z_l = torch.randn(mu.shape, generator=generator,
                          device=x.device) * torch.exp(ls) + mu
        return z_g, mu_g, ls_g, z_l, mu, ls

    def decode(self, z_global, z_local):
        b, d = z_global.shape[0], self.input_dim
        ctx = z_local.reshape(b, self.num_points, self.latent_dim + d)
        return self.decoder.layers(ctx, style=z_global) * self.skip_weight \
            + ctx[..., :d]


class BlockSEDrop(nn.Module):
    def __init__(self, dim, dropout):
        super().__init__()
        self.drop = Dropout(dropout)
        self.conv1 = Dense(dim, dim)
        self.conv2 = Dense(dim, dim)
        self.se_fc1 = Dense(dim // 8, dim, bias=False)
        self.se_fc2 = Dense(dim, dim // 8, bias=False)

    def forward(self, x, t):
        h = torch.relu(self.conv2(self.drop(torch.relu(self.conv1(x + t)))))
        return x + h * torch.sigmoid(self.se_fc2(torch.relu(self.se_fc1(h))))


class BlockSEClip(nn.Module):
    def __init__(self, dim):
        super().__init__()
        self.dim = dim
        self.conv1 = Dense(dim, dim * 2)
        self.conv2 = Dense(dim, dim)
        self.se_fc1 = Dense(dim // 8, dim, bias=False)
        self.se_fc2 = Dense(dim, dim // 8, bias=False)

    def forward(self, x, t):
        temb, clip = t[:, :self.dim], t[:, self.dim:]
        h = torch.relu(self.conv1(torch.cat([x + temb, clip], dim=-1)))
        h = torch.relu(self.conv2(h))
        return x + h * torch.sigmoid(self.se_fc2(torch.relu(self.se_fc1(h))))


class GlobalPrior(nn.Module):
    """Dense ResNet over the style latent with the positional time
    embedding; under CLIP the mapped features join the embedding."""

    def __init__(self, cfg):
        super().__init__()
        sde = cfg["sde"]
        if sde["embedding_type"] != "positional" or sde["mixed_prediction"]:
            raise NotImplementedError("the reference covers the released "
                                      "priors: positional, no mixing")
        nf, emb = sde["num_channels_dae"], sde["embedding_dim"]
        self.clip = bool(cfg["clipforge"]["enable"])
        style = cfg["latent_pts"]["style_dim"]
        self.emb_dim, self.emb_scale = emb, sde["embedding_scale"]
        self.temb0 = Dense(emb * 4, emb)
        self.temb1 = Dense(nf, emb * 4)
        self.clip_feat_mapping = Dense(nf, cfg["clipforge"]["feat_dim"]) \
            if self.clip else None
        self.input_layer = Dense(nf, style)
        self.n = sde["num_cell_per_scale_dae"]
        for i in range(self.n):
            self.add_module(f"block{i}", BlockSEClip(nf) if self.clip
                            else BlockSEDrop(nf, sde["dropout"]))
        self.output_layer = Dense(style, nf)

    def forward(self, x, t, clip_feat=None):
        t = torch.as_tensor(t, dtype=torch.float32,
                            device=x.device).reshape(-1).expand(x.shape[0])
        temb = self.temb1(self.temb0(timestep_embedding(t, self.emb_dim,
                                                        self.emb_scale)))
        if self.clip:
            temb = torch.cat([temb, self.clip_feat_mapping(clip_feat)],
                             dim=-1)
        h = self.input_layer(x)
        for i in range(self.n):
            h = getattr(self, f"block{i}")(h, temb)
        return self.output_layer(h)


class LocalPrior(nn.Module):
    """The AdaGN U-Net over the latent points, styled by the global
    latent."""

    def __init__(self, cfg):
        super().__init__()
        sa, fp, vres, ncent = _specs(cfg, PRIOR_SA)
        z = cfg["shapelatent"]["latent_dim"]
        d = cfg["ddpm"]["input_dim"]
        self.n, self.c = cfg["data"]["tr_max_sample_points"], z + d
        self.unet = Unet(
            z + d, sa, fp, embed_dim=cfg["ddpm"]["time_dim"], extra=z,
            input_dim=d, temb_scale=cfg["sde"]["embedding_scale"],
            style_dim=cfg["latent_pts"]["style_dim"],
            init_scale=cfg["latent_pts"]["ada_mlp_init_scale"],
            vres_mult=vres, ncenter_mult=ncent,
            dropout=cfg["ddpm"]["dropout"],
            clip=bool(cfg["clipforge"]["enable"]),
            clip_dim=cfg["clipforge"]["feat_dim"])

    def forward(self, x, t, condition, clip_feat=None):
        b = x.shape[0]
        out = self.unet(x.reshape(b, self.n, self.c), t=t, style=condition,
                        clip_feat=clip_feat)
        return out.reshape(x.shape)


class Lion(nn.Module):
    """The whole model under the measured program's top-level names."""

    def __init__(self, cfg):
        super().__init__()
        if cfg["data"].get("cond_on_cat"):
            raise NotImplementedError("class conditioning")
        self.vae = VAE(cfg)
        self.global_prior = GlobalPrior(cfg)
        self.local_prior = LocalPrior(cfg)
