from .autoencoder import AutoencoderKL
from .clip import CLIPTextTower, CLIPVisionTower, OpenCLIPTextVisual
from .unet_i2v import UNetSD_I2VGen
from .unet_t2v import UNetSD_T2VBase, build_unet_plan

__all__ = ["AutoencoderKL", "CLIPTextTower", "CLIPVisionTower", "OpenCLIPTextVisual",
           "UNetSD_I2VGen", "UNetSD_T2VBase", "build_unet_plan"]
