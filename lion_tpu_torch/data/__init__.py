"""Data: the ShapeNet15k loader in the PointFlow layout (port of
lion_tpu/data)."""
from .shapenet import (DataLoader, ShapeNet15kPointClouds, cate_to_synsetid,
                       get_data_loaders, get_datasets, synsetid_to_cate)

__all__ = ["DataLoader", "ShapeNet15kPointClouds", "cate_to_synsetid",
           "get_data_loaders", "get_datasets", "synsetid_to_cate"]
