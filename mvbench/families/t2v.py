"""The T2V configuration's program: ``videomv_tpu_torch``'s ``T2VPipeline``
driven as its CLI serves a prompt (``generate``), with the benchmark's
seeded weights loaded through ``load_state_dicts``. What the benchmark
records of it and how it is judged is ``videomv.py``'s, shared with
``i2v``."""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from ..reference import counting
from . import videomv

Watch = videomv.Watch


class Program:
    I2V = False
    # the pipeline's methods that encode a request's conditioning (the encode span)
    ENCODE_METHODS = ("encode_text",)
    # the denoiser's keyword inputs that carry the conditioning, cond row first
    COND_KWARGS = {"y": "y"}

    def __init__(self, config: dict, mix: dict, device):
        from videomv_tpu_torch.config import AttrDict

        self.pipe = self._pipeline_class()(AttrDict(config["pipeline"]), device=device, seed=0)
        self.steps = int(config["pipeline"].get("ddim_timesteps", 50))
        self.refine = bool(mix["refine"])

    def shapes(self) -> Dict[str, list]:
        """``(name, shape)`` of every tensor of each model the pipeline built."""
        return {n: [(k, t.shape) for k, t in m.state_dict().items()]
                for n, m in self.pipe.models.items()}

    def load(self, state_dicts: Dict[str, Dict[str, torch.Tensor]]) -> None:
        self.pipe.load_state_dicts(**state_dicts)

    def swap(self, models: Dict[str, torch.nn.Module]) -> None:
        """Other modules in the place of the pipeline's (the control)."""
        for name, m in models.items():
            setattr(self.pipe, name, m)

    @staticmethod
    def _pipeline_class():
        from videomv_tpu_torch.inference.pipeline import T2VPipeline

        return T2VPipeline

    @staticmethod
    def refine_factories():
        """``(module, name)`` of each place the pipeline takes its refine
        function's factory from."""
        from videomv_tpu_torch.inference import pipeline

        return [(pipeline, "make_refine_fn")]

    def request(self, item: dict) -> dict:
        return self.pipe.generate(item["prompt"], steps=self.steps, use_gs_refine=self.refine,
                                  seed=item["seed"])

    @staticmethod
    def finite(out: dict) -> bool:
        return bool(np.isfinite(np.asarray(out["latents"])).all())


def work(config: dict, mix: dict) -> Dict[str, object]:
    """The model FLOPs and the attention and feed-forward calls of one request."""
    return counting.work(config, Program.I2V, mix)


def control(config: dict, state_dicts, device) -> dict:
    return videomv.control(config, Program.I2V, state_dicts, device)
