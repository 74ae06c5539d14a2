from .i2v import I2VPipeline
from .pipeline import T2VPipeline, unet_kwargs_from_cfg

__all__ = ["I2VPipeline", "T2VPipeline", "unet_kwargs_from_cfg"]
