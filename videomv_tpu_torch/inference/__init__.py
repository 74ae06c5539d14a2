from .i2v import I2VPipeline
from .pipeline import T2VPipeline, unet_kwargs_from_cfg
from .sv3d import SV3DPipeline

__all__ = ["I2VPipeline", "SV3DPipeline", "T2VPipeline", "unet_kwargs_from_cfg"]
