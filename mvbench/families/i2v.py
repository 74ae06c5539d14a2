"""The I2V configuration's program: ``videomv_tpu_torch``'s ``I2VPipeline``
driven as its CLI serves an image (``generate_from_image``), with the
benchmark's seeded weights loaded through ``load_state_dicts``."""

from __future__ import annotations

from typing import Dict

from ..reference import counting
from . import t2v, videomv

Watch = videomv.Watch


class Program(t2v.Program):
    I2V = True
    ENCODE_METHODS = ("encode_text", "encode_image_clip", "encode_local_latent")
    COND_KWARGS = {"y": "y", "image": "image", "local": "local_image"}

    @staticmethod
    def _pipeline_class():
        from videomv_tpu_torch.inference.i2v import I2VPipeline

        return I2VPipeline

    @staticmethod
    def refine_factories():
        from videomv_tpu_torch.inference import i2v

        return [(i2v, "make_refine_fn")]

    def request(self, item: dict) -> dict:
        return self.pipe.generate_from_image(item["image"], steps=self.steps,
                                             use_gs_refine=self.refine, seed=item["seed"])


def work(config: dict, mix: dict) -> Dict[str, object]:
    return counting.work(config, Program.I2V, mix)


def control(config: dict, state_dicts, device) -> dict:
    return videomv.control(config, Program.I2V, state_dicts, device)
