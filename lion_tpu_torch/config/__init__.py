from .cfg_node import CfgNode
from .default import default_cfg_for, get_default_cfg
from .flagship import flagship_cfg
from .view import CfgView, as_view

__all__ = ["CfgNode", "default_cfg_for", "get_default_cfg", "flagship_cfg", "CfgView",
           "as_view"]
