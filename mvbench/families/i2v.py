"""The I2V configuration's program: ``videomv_tpu_torch``'s ``I2VPipeline``
driven as its CLI serves an image (``generate_from_image``), with the
benchmark's seeded weights loaded through ``load_state_dicts``."""

from __future__ import annotations

from . import t2v

I2V = True
ENCODE_METHODS = ("encode_text", "encode_image_clip", "encode_local_latent")
COND_KWARGS = {"y": "y", "image": "image", "local": "local_image"}


class Program(t2v.Program):
    @staticmethod
    def _pipeline_class():
        from videomv_tpu_torch.inference.i2v import I2VPipeline

        return I2VPipeline

    @staticmethod
    def refine_factories():
        from videomv_tpu_torch.inference import i2v

        return [(i2v, "make_refine_fn")]

    def request(self, item: dict, seed: int, refine: bool) -> dict:
        return self.pipe.generate_from_image(item["image"], steps=self.steps,
                                             use_gs_refine=refine, seed=seed)
