from .autoencoder import AutoencoderKL
from .blocks import (
    DropPath,
    RelativePositionBias,
    TemporalAttentionBlock,
    TemporalAttentionMultiBlock,
    TemporalTransformerAttemask,
    rotary_rotate,
)
from .clip import CLIPTextTower, CLIPVisionTower, OpenCLIPTextVisual
from .lgm import LGM, LGMOptions
from .lpips import LPIPS
from .unet_i2v import UNetSD_I2VGen
from .unet_t2v import UNetSD_T2VBase, build_unet_plan

__all__ = ["LGM", "LPIPS", "AutoencoderKL", "CLIPTextTower", "CLIPVisionTower", "DropPath",
           "LGMOptions", "OpenCLIPTextVisual", "RelativePositionBias", "TemporalAttentionBlock",
           "TemporalAttentionMultiBlock", "TemporalTransformerAttemask", "UNetSD_I2VGen",
           "UNetSD_T2VBase", "build_unet_plan", "rotary_rotate"]
