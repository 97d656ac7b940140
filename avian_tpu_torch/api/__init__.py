"""The 3D extension points: user shapes (``custom_shapes``) and the XPBD
helpers of user constraints (``custom``)."""

from avian_tpu_torch.api.custom_shapes import CUSTOM_SHAPE_BASE, CustomShape, point_patch

__all__ = ["CUSTOM_SHAPE_BASE", "CustomShape", "point_patch"]
