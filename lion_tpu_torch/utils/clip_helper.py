"""CLIP text and image features for clip-forge conditioning (the port's
copy of lion_tpu/utils/clip_helper.py).

The reference loads OpenAI CLIP ViT-B/32 at run time for text-to-shape
demos and single-view reconstruction training (`demo.py:31-36`,
`trainers/base_trainer.py:821-853`, `trainers/train_2prior.py:248-258` in
nv-tlabs/LION). Here the encoder is a host-side preprocessing step: the
features are (B, 512) float32 rows that the samplers and the training
steps take as `clip_feat`.

Two encoders:
- `TransformersClip`: real CLIP through `transformers.CLIPModel`, imported
  when built. It needs weights on disk (a local path, or LION_CLIP_MODEL);
  it reads no network unless LION_CLIP_ONLINE=1.
- `HashClip`: a deterministic stand-in (a Gaussian seeded by the SHA-256
  of the prompt or the pixels) with CLIP's shape and norm, so the whole
  text-to-shape pipeline runs without CLIP weights.

`get_clip_encoder` picks one: the real encoder when it loads, else
`HashClip` (with `allow_fallback`).
"""
from __future__ import annotations

import hashlib
import os
from typing import List, Optional, Sequence

import numpy as np

CLIP_FEAT_DIM = 512  # ViT-B/32 projection dim (reference default_config.py: clipforge.feat_dim)


class HashClip:
    """Deterministic stand-in for CLIP: maps each prompt/image to a fixed
    unit-norm pseudo-embedding via a SHA256-seeded Gaussian.  Identical
    prompts always give identical features (so conditioning is meaningful in
    smoke tests), but there is no semantic structure."""

    def __init__(self, feat_dim: int = CLIP_FEAT_DIM):
        self.feat_dim = feat_dim
        self.is_real = False

    def _embed_key(self, key: bytes) -> np.ndarray:
        seed = int.from_bytes(hashlib.sha256(key).digest()[:8], "little")
        v = np.random.default_rng(seed).standard_normal(self.feat_dim)
        return (v / np.linalg.norm(v)).astype(np.float32)

    def encode_text(self, prompts: Sequence[str]) -> np.ndarray:
        return np.stack([self._embed_key(p.encode()) for p in prompts])

    def encode_image(self, images) -> np.ndarray:
        images = np.asarray(images)
        flat = images.reshape(images.shape[0], -1)
        return np.stack([self._embed_key(np.ascontiguousarray(x).tobytes())
                         for x in flat])


class TransformersClip:
    """Real CLIP through HuggingFace transformers, CPU torch.

    model: hub id or local directory (e.g. "openai/clip-vit-base-patch32").
    Features are L2-normalized projection outputs, matching the reference's
    `clip_model.encode_text(...)` usage (demo.py:31-36) — the reference does
    not normalize for the trainer path, so set `normalize=False` there
    (trainers/train_2prior.py:252-255 takes raw `.encode_image` output).
    """

    def __init__(self, model: str = "openai/clip-vit-base-patch32",
                 normalize: bool = True):
        import torch  # noqa: F401 — fail early if torch is absent
        from transformers import CLIPModel, CLIPProcessor
        # offline-first: resolve from local cache/dir without hub round trips
        # (set LION_CLIP_ONLINE=1 to allow downloads)
        offline = os.environ.get("LION_CLIP_ONLINE", "0") != "1"
        kw = {"local_files_only": True} if offline else {}
        self.model = CLIPModel.from_pretrained(model, **kw)
        self.model.eval()
        self.processor = CLIPProcessor.from_pretrained(model, **kw)
        self.normalize = normalize
        self.feat_dim = int(self.model.config.projection_dim)
        self.is_real = True

    def _maybe_norm(self, t):
        import torch
        if self.normalize:
            t = t / t.norm(dim=-1, keepdim=True)
        return t.detach().cpu().numpy().astype(np.float32)

    def encode_text(self, prompts: Sequence[str]) -> np.ndarray:
        import torch
        inputs = self.processor(text=list(prompts), return_tensors="pt",
                                padding=True, truncation=True)
        with torch.no_grad():
            feat = self.model.get_text_features(**inputs)
        return self._maybe_norm(feat)

    def encode_image(self, images) -> np.ndarray:
        """images: list of PIL images, or (B, H, W, 3) uint8 array."""
        import torch
        images = list(images)
        inputs = self.processor(images=images, return_tensors="pt")
        with torch.no_grad():
            feat = self.model.get_image_features(**inputs)
        return self._maybe_norm(feat)


# Reference configs carry OpenAI CLIP naming (default_config.py
# clipforge.clip_model = 'ViT-B/32'); transformers resolves HF hub ids, so
# map the released names — otherwise ClipForge silently falls back to
# HashClip even with real cached weights.
_OPENAI_TO_HF = {
    "ViT-B/32": "openai/clip-vit-base-patch32",
    "ViT-B/16": "openai/clip-vit-base-patch16",
    "ViT-L/14": "openai/clip-vit-large-patch14",
    "ViT-L/14@336px": "openai/clip-vit-large-patch14-336",
}


def get_clip_encoder(model_name: Optional[str] = None,
                     allow_fallback: bool = True,
                     normalize: bool = True):
    """Load the best available CLIP encoder.

    Resolution order: $LION_CLIP_MODEL > explicit arg > hub default — env
    first, because the arg is usually the config default 'ViT-B/32' and the
    env var exists precisely to redirect it at a local weight directory.
    OpenAI CLIP names (the reference's config convention) are mapped to
    their HF hub ids. When weights cannot be loaded (no network, no cache)
    and allow_fallback is set, returns a HashClip so pipelines still run;
    callers can check `.is_real` to warn.
    """
    name = (os.environ.get("LION_CLIP_MODEL") or model_name
            or "openai/clip-vit-base-patch32")
    name = _OPENAI_TO_HF.get(name, name)
    try:
        return TransformersClip(name, normalize=normalize)
    except Exception:
        if not allow_fallback:
            raise
        return HashClip()
