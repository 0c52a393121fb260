"""ShapeNet15k point clouds in the PointFlow layout and their batches (port
of lion_tpu/data/shapenet.py).

The dataset reads the 15k-point `.npy` clouds of
`<root>/<synset>/<split>/*.npy` (in one bulk read by the native threaded
reader, data/native.py, when every file has the same row count, else one
`np.load` a file), shuffles them with the seed 38383, normalizes them by
one of the four modes and subsamples `tr_points` / `input_pts` per item;
`DataLoader` batches them per epoch, reshuffled by `set_epoch`, one shard
of `num_shards` (a trainer's rank of the world, trainers/base.py). For the
same root and seed the batches equal the JAX package's bit for bit.

With `clip_forge_enable` each item also carries `num_imgs_per_item` random
render views of its shape, `<clip_img_root>/<synset>/<id>/img_choy2016/
*.{jpg,png}`, resized to `clip_img_size` and stacked as (K, S, S, 3) uint8
under `tr_img` (lion_tpu/data/shapenet.py:59-73, 104-111, 218-236); the
trainer's CLIP encoder reads them. They are decoded with PIL, which the
dataset checks for when it is built.
"""
from __future__ import annotations

import os
import random
from typing import List, Optional, Sequence

import numpy as np

from .native import load_npy_batch, npy_shape


def check_pil() -> None:
    """The render images decode with PIL: raise at build, with a clear
    message, when it cannot be imported."""
    try:
        import PIL.Image  # noqa: F401
    except ImportError as err:
        raise ImportError(
            f"data.clip_forge_enable reads the render images with PIL, which"
            f" cannot be imported ({err}); install Pillow or set "
            "data.clip_forge_enable 0") from err


def _rows(path: str) -> int:
    shape = npy_shape(path)
    return shape[0] if shape else np.load(path, mmap_mode="r").shape[0]


# standard ShapeNetCore.v2 synset map (pointflow_datasets.py:26-85)
synsetid_to_cate = {
    "02691156": "airplane", "02773838": "bag", "02801938": "basket",
    "02808440": "bathtub", "02818832": "bed", "02828884": "bench",
    "02876657": "bottle", "02880940": "bowl", "02924116": "bus",
    "02933112": "cabinet", "02747177": "can", "02942699": "camera",
    "02954340": "cap", "02958343": "car", "03001627": "chair",
    "03046257": "clock", "03207941": "dishwasher", "03211117": "monitor",
    "04379243": "table", "04401088": "telephone", "02946921": "tin_can",
    "04460130": "tower", "04468005": "train", "03085013": "keyboard",
    "03261776": "earphone", "03325088": "faucet", "03337140": "file",
    "03467517": "guitar", "03513137": "helmet", "03593526": "jar",
    "03624134": "knife", "03636649": "lamp", "03642806": "laptop",
    "03691459": "speaker", "03710193": "mailbox", "03759954": "microphone",
    "03761084": "microwave", "03790512": "motorcycle", "03797390": "mug",
    "03928116": "piano", "03938244": "pillow", "03948459": "pistol",
    "03991062": "pot", "04004475": "printer", "04074963": "remote_control",
    "04090263": "rifle", "04099429": "rocket", "04225987": "skateboard",
    "04256520": "sofa", "04330267": "stove", "04530566": "vessel",
    "04554684": "washer", "02992529": "cellphone", "02843684": "birdhouse",
    "02871439": "bookshelf",
}
cate_to_synsetid = {v: k for k, v in synsetid_to_cate.items()}


class ShapeNet15kPointClouds:
    """In-memory ShapeNet15k split with reference-parity normalization."""

    def __init__(self, root_dir: str, categories: Sequence[str] = ("chair",),
                 split: str = "train", tr_sample_size: int = 2048,
                 te_sample_size: int = 2048,
                 normalize_per_shape: bool = False,
                 normalize_shape_box: bool = False,
                 normalize_std_per_axis: bool = False,
                 normalize_global: bool = False,
                 recenter_per_shape: bool = True,
                 all_points_mean: Optional[np.ndarray] = None,
                 all_points_std: Optional[np.ndarray] = None,
                 random_subsample: bool = True,
                 sample_with_replacement: bool = True,
                 input_dim: int = 3,
                 clip_forge_enable: bool = False,
                 clip_img_root: Optional[str] = None,
                 clip_img_size: int = 224,
                 num_imgs_per_item: int = 5):
        if split not in ("train", "test", "val"):
            raise ValueError(f"split {split!r}")
        self.split = split
        self.input_dim = input_dim
        self.clip_forge_enable = bool(clip_forge_enable)
        if self.clip_forge_enable:
            check_pil()
            if not clip_img_root:
                raise ValueError("clip_forge_enable needs clip_img_root")
        self.clip_img_root = clip_img_root
        self.clip_img_size = int(clip_img_size)
        self.num_imgs_per_item = int(num_imgs_per_item)
        self.random_subsample = random_subsample
        self.sample_with_replacement = sample_with_replacement
        self.recenter_per_shape = recenter_per_shape
        self.normalize_per_shape = normalize_per_shape
        self.normalize_shape_box = normalize_shape_box
        if isinstance(categories, str):
            categories = [categories]
        if "all" in categories:
            self.synset_ids = list(cate_to_synsetid.values())
        else:
            self.synset_ids = [cate_to_synsetid[c] for c in categories]
        self.gravity_axis = 1
        self.display_axis_order = [0, 2, 1]

        paths: List[str] = []
        self.cate_idx_lst: List[int] = []
        self.all_cate_mids: List = []
        self.img_path: List[str] = []
        for cate_idx, subd in enumerate(self.synset_ids):
            sub_path = os.path.join(root_dir, subd, split)
            if not os.path.isdir(sub_path):
                continue
            for fname in sorted(os.listdir(sub_path)):
                if not fname.endswith(".npy"):
                    continue
                mid = os.path.join(split, fname[:-len(".npy")])
                paths.append(os.path.join(sub_path, fname))
                self.cate_idx_lst.append(cate_idx)
                self.all_cate_mids.append((subd, mid))
                if self.clip_forge_enable:
                    # <img_root>/<synset>/<id>/img_choy2016
                    # (pointflow_datasets.py:176-182)
                    render = os.path.join(self.clip_img_root, subd,
                                          fname[:-len(".npy")],
                                          "img_choy2016")
                    if not os.path.exists(render):
                        raise FileNotFoundError(
                            f"render img path not found: {render}")
                    self.img_path.append(render)
        if not paths:
            raise FileNotFoundError(
                f"no .npy point clouds under {root_dir} for "
                f"{self.synset_ids} split={split}")

        # one bulk read through the native reader when every file has the
        # same row count (the ShapeNet15k layout), as lion_tpu reads them
        rows = {_rows(p) for p in paths}
        if len(rows) == 1:
            stacked = load_npy_batch(paths, n_points=rows.pop(),
                                     dims=input_dim)
            all_points = [stacked[i][np.newaxis] for i in range(len(paths))]
        else:
            all_points = [np.load(p)[np.newaxis, ...] for p in paths]

        # deterministic shuffle, seed 38383 (pointflow_datasets.py:196)
        shuffle_idx = list(range(len(all_points)))
        random.Random(38383).shuffle(shuffle_idx)
        self.cate_idx_lst = [self.cate_idx_lst[i] for i in shuffle_idx]
        all_points = [all_points[i] for i in shuffle_idx]
        self.all_cate_mids = [self.all_cate_mids[i] for i in shuffle_idx]
        if self.clip_forge_enable:
            self.img_path = [self.img_path[i] for i in shuffle_idx]

        self.all_points = np.concatenate(all_points)  # (B, 15000, 3)
        b, n = self.all_points.shape[:2]

        if normalize_shape_box or recenter_per_shape:
            # bbox center + half largest side (both modes share the math)
            pmax = self.all_points.max(axis=1).reshape(b, 1, input_dim)
            pmin = self.all_points.min(axis=1).reshape(b, 1, input_dim)
            self.all_points_mean = (pmax + pmin) / 2
            self.all_points_std = (pmax - pmin).max(axis=-1) \
                                               .reshape(b, 1, 1) / 2
        elif normalize_per_shape:
            self.all_points_mean = self.all_points.mean(axis=1) \
                                                  .reshape(b, 1, input_dim)
            if normalize_std_per_axis:
                self.all_points_std = self.all_points.std(axis=1) \
                                                     .reshape(b, 1, input_dim)
            else:
                self.all_points_std = self.all_points.reshape(b, -1) \
                    .std(axis=1).reshape(b, 1, 1)
        elif all_points_mean is not None and all_points_std is not None:
            self.all_points_mean = all_points_mean
            self.all_points_std = all_points_std
        elif normalize_global:
            flat = self.all_points.reshape(-1, input_dim)
            self.all_points_mean = flat.mean(axis=0).reshape(1, 1, input_dim)
            if normalize_std_per_axis:
                self.all_points_std = flat.std(axis=0).reshape(1, 1,
                                                               input_dim)
            else:
                self.all_points_std = flat.reshape(-1).std().reshape(1, 1, 1)
        else:
            raise NotImplementedError("No Normalization")

        self.all_points = ((self.all_points - self.all_points_mean)
                           / self.all_points_std).astype(np.float32)
        self.train_points = self.all_points[:, :min(10000, n)]
        self.tr_sample_size = min(10000, tr_sample_size)
        self.te_sample_size = min(5000, te_sample_size)

    def get_pc_stats(self, idx):
        if (self.recenter_per_shape or self.normalize_per_shape
                or self.normalize_shape_box):
            m = self.all_points_mean[idx].reshape(1, self.input_dim)
            s = self.all_points_std[idx].reshape(1, -1)
            return m, s
        return (self.all_points_mean.reshape(1, -1),
                self.all_points_std.reshape(1, -1))

    def __len__(self):
        return len(self.train_points)

    def __getitem__(self, idx, rng: Optional[np.random.RandomState] = None):
        rng = rng or np.random
        tr_out = self.train_points[idx]
        if self.random_subsample and self.sample_with_replacement:
            tr_idxs = rng.choice(tr_out.shape[0], self.tr_sample_size)
        elif self.random_subsample:
            tr_idxs = rng.permutation(
                np.arange(tr_out.shape[0]))[:self.tr_sample_size]
        else:
            tr_idxs = np.arange(self.tr_sample_size)
        tr_out = tr_out[tr_idxs].astype(np.float32)
        m, s = self.get_pc_stats(idx)
        sid, mid = self.all_cate_mids[idx]
        out = {
            "idx": idx,
            "select_idx": tr_idxs,
            "tr_points": tr_out,
            "input_pts": tr_out,
            "mean": m, "std": s,
            "cate_idx": self.cate_idx_lst[idx],
            "sid": sid, "mid": mid,
            "display_axis_order": self.display_axis_order,
        }
        if self.clip_forge_enable:
            out["tr_img"] = self._load_render_imgs(idx, rng)
        return out

    def _load_render_imgs(self, idx, rng=None) -> np.ndarray:
        """`num_imgs_per_item` random render views (K, S, S, 3) uint8
        (pointflow_datasets.py:340-353; the CLIP preprocessing is the
        trainer's encoder's)."""
        rng = rng or np.random
        from PIL import Image
        d = self.img_path[idx]
        files = sorted(f for f in os.listdir(d)
                       if f.endswith(("jpg", "png")))
        if not files:
            raise FileNotFoundError(f"empty render dir {d}")
        pick = rng.choice(len(files), self.num_imgs_per_item)
        imgs = []
        for o in pick:
            img = Image.open(os.path.join(d, files[int(o)])).convert("RGB")
            img = img.resize((self.clip_img_size, self.clip_img_size),
                             Image.BICUBIC)
            imgs.append(np.asarray(img, np.uint8))
        return np.stack(imgs)


class DataLoader:
    """Minimal epoch-based batcher with per-host sharding.

    Replaces torch DataLoader + DistributedSampler: each host sees a
    disjoint 1/num_shards slice, reshuffled per epoch via set_epoch
    (reference: pointflow_datasets.py:421-423, base_trainer.py:190-191).
    """

    def __init__(self, dataset, batch_size: int, shuffle: bool = True,
                 drop_last: bool = True, seed: int = 0,
                 num_shards: int = 1, shard_id: int = 0):
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.drop_last = drop_last
        self.seed = seed
        self.num_shards = num_shards
        self.shard_id = shard_id
        self.epoch = 0

    def set_epoch(self, epoch: int):
        self.epoch = epoch

    def __len__(self):
        n = len(self.dataset) // self.num_shards
        if self.drop_last:
            return n // self.batch_size
        return (n + self.batch_size - 1) // self.batch_size

    def __iter__(self):
        n = len(self.dataset)
        order = np.arange(n)
        if self.shuffle:
            order = np.random.RandomState(
                self.seed + self.epoch).permutation(n)
        order = order[self.shard_id::self.num_shards]
        item_rng = np.random.RandomState(
            (self.seed + self.epoch) * 997 + self.shard_id)
        num_batches = len(self)
        for bi in range(num_batches):
            idxs = order[bi * self.batch_size:(bi + 1) * self.batch_size]
            if len(idxs) == 0:
                return
            items = [self.dataset.__getitem__(int(i), rng=item_rng)
                     for i in idxs]
            batch = {
                "tr_points": np.stack([it["tr_points"] for it in items]),
                "input_pts": np.stack([it["input_pts"] for it in items]),
                "mean": np.stack([it["mean"] for it in items]),
                "std": np.stack([it["std"] for it in items]),
                "cate_idx": np.asarray([it["cate_idx"] for it in items]),
                "idx": np.asarray([it["idx"] for it in items]),
            }
            if "tr_img" in items[0]:
                batch["tr_img"] = np.stack([it["tr_img"] for it in items])
            yield batch


def get_datasets(cfg_data, root_dir: Optional[str] = None):
    """Build train/test datasets from cfg.data (pointflow_datasets.py:363-415)."""
    root = root_dir or cfg_data.data_dir
    cates = cfg_data.cates
    cates = cates.split(",") if isinstance(cates, str) else cates
    kwargs = dict(
        categories=cates,
        tr_sample_size=cfg_data.tr_max_sample_points,
        te_sample_size=cfg_data.te_max_sample_points,
        normalize_per_shape=bool(cfg_data.normalize_per_shape),
        normalize_shape_box=bool(cfg_data.normalize_shape_box),
        normalize_std_per_axis=bool(cfg_data.normalize_std_per_axis),
        normalize_global=bool(cfg_data.normalize_global),
        recenter_per_shape=bool(cfg_data.recenter_per_shape),
        random_subsample=bool(cfg_data.random_subsample),
        sample_with_replacement=bool(cfg_data.sample_with_replacement),
        clip_forge_enable=bool(getattr(cfg_data, "clip_forge_enable", 0)),
        clip_img_root=getattr(cfg_data, "clip_img_root", None) or None,
    )
    train = ShapeNet15kPointClouds(root, split="train", **kwargs)
    eval_split = "test" if cfg_data.eval_test_split else "val"
    test = ShapeNet15kPointClouds(
        root, split=eval_split,
        all_points_mean=train.all_points_mean
        if not train.recenter_per_shape else None,
        all_points_std=train.all_points_std
        if not train.recenter_per_shape else None,
        **kwargs)
    return train, test


def get_data_loaders(cfg_data, root_dir: Optional[str] = None, seed: int = 0,
                     num_shards: int = 1, shard_id: int = 0):
    train, test = get_datasets(cfg_data, root_dir)
    return {
        "train_loader": DataLoader(train, cfg_data.batch_size, shuffle=True,
                                   drop_last=bool(cfg_data.train_drop_last),
                                   seed=seed, num_shards=num_shards,
                                   shard_id=shard_id),
        "test_loader": DataLoader(test, cfg_data.batch_size_test,
                                  shuffle=False, drop_last=False, seed=seed),
    }
