"""LPIPS perceptual distance (VGG16 backbone) for the LGM's supervision.

Port of ``videomv_tpu/models/lpips.py``. The reference supervises the LGM's
re-rendered views with ``MSE + lambda_lpips · LPIPS(net='vgg')``
(core/models.py:30-37, 167-184); its LPIPS is the richzhang package: a
frozen torchvision VGG16 feature tower tapped at relu1_2 / relu2_2 /
relu3_3 / relu4_3 / relu5_3, per-channel unit normalisation, learned 1×1
"lin" heads, a spatial mean, summed over the five taps.

Module paths are the keys of the released ``vgg.pth`` (``net.slice2.5``,
``lin0.model.1``), so that file loads directly
(``training.checkpoints.rename_lpips_key``), and a Flax tree of the JAX
package's ``LPIPS`` converts with ``state_dict_from_flax``. Inputs are NCHW
images in [-1, 1]. The module is never trained: the caller differentiates
through it to the rendered image only.
"""

from __future__ import annotations

from typing import List

import torch
import torch.nn.functional as F
from torch import nn

__all__ = ["LPIPS"]

# torchvision VGG16 ``features`` indices of the conv layers in each slice
_SLICES = ((0, 2), (5, 7), (10, 12, 14), (17, 19, 21), (24, 26, 28))
_CHANNELS = (64, 64, 128, 128, 256, 256, 256, 512, 512, 512, 512, 512, 512)
_TAP_CHANNELS = (64, 128, 256, 512, 512)
# the ScalingLayer's constants (buffers in the released file; fixed)
_SHIFT = (-0.030, -0.088, -0.188)
_SCALE = (0.458, 0.448, 0.450)


def _unit_normalize(x: torch.Tensor, eps: float = 1e-10) -> torch.Tensor:
    """Channel-unit normalisation (lpips.normalize_tensor), NCHW."""
    return x / (x.pow(2).sum(dim=1, keepdim=True).sqrt() + eps)


class LPIPS(nn.Module):
    """``forward(x0, x1)``, NCHW float images in [-1, 1] → ``[B]`` distances."""

    def __init__(self):
        super().__init__()
        self.net = nn.Module()
        channels = iter(_CHANNELS)
        cin = 3
        for si, conv_ids in enumerate(_SLICES):
            sl = nn.Module()
            for ci in conv_ids:
                cout = next(channels)
                sl.add_module(str(ci), nn.Conv2d(cin, cout, 3, padding=1))
                cin = cout
            self.net.add_module(f"slice{si + 1}", sl)
        for i, c in enumerate(_TAP_CHANNELS):
            lin = nn.Module()
            lin.model = nn.Module()
            lin.model.add_module("1", nn.Conv2d(c, 1, 1, bias=False))
            self.add_module(f"lin{i}", lin)

    def _vgg_taps(self, x: torch.Tensor) -> List[torch.Tensor]:
        taps = []
        for si, conv_ids in enumerate(_SLICES):
            if si > 0:  # each later slice starts with the 2×2 max-pool
                x = F.max_pool2d(x, 2)
            sl = getattr(self.net, f"slice{si + 1}")
            for ci in conv_ids:
                x = F.relu(getattr(sl, str(ci))(x))
            taps.append(x)
        return taps

    def forward(self, x0: torch.Tensor, x1: torch.Tensor) -> torch.Tensor:
        dt = self.lin0.model.get_submodule("1").weight.dtype
        shift = torch.tensor(_SHIFT, device=x0.device, dtype=dt).reshape(1, 3, 1, 1)
        scale = torch.tensor(_SCALE, device=x0.device, dtype=dt).reshape(1, 3, 1, 1)
        b = x0.shape[0]
        # one tower pass over the stacked pair keeps the convolutions batched
        taps = self._vgg_taps((torch.cat([x0, x1]).to(dt) - shift) / scale)
        total = torch.zeros(b, device=x0.device, dtype=dt)
        for i, t in enumerate(taps):
            diff = (_unit_normalize(t[:b]) - _unit_normalize(t[b:])) ** 2
            head = getattr(self, f"lin{i}").model.get_submodule("1")
            total = total + head(diff).mean(dim=(1, 2, 3))
        return total
