"""Weights for the port: released torch checkpoints, the bridge from a JAX
(Flax) parameter tree, and seeded / fresh initialisation.

The port's modules are named after the released checkpoint keys, so a
released ``.pth``/``.bin``/``.safetensors`` loads into them directly
(``load_torch_checkpoint`` + ``load_matched``). ``state_dict_from_flax`` is
the inverse of the JAX package's ``map_torch_to_flax``/``_convert_tensor``:
it turns a flattened Flax tree into a ``state_dict`` for a port module, so
both packages can run on the same weights.

Initialisation draws from numpy ``default_rng(seed)`` (never from torch's
global generator): ``init_weights`` gives every tensor
``standard_normal(shape)`` scaled by its fan-in (norm scales 1 + 0.1·n,
biases 0.1·n), and with ``zero_init=True`` zeroes the layers the JAX
package zero-initialises (tagged by ``models.blocks.zero_module``), so a
fresh UNet outputs exactly 0. ``zero_init=False`` gives the "seeded"
weights the parity tests and the smoke test use, where every layer acts.
The draw is the cost (one numpy stream per module, ≈ 1.4 G values for the
UNet): it runs in a worker thread one parameter ahead of the scaling and the
copy to the device, and ``init_models`` seeds several modules at once, each
from its own stream; the values are those of one plain sequential pass.
"""

from __future__ import annotations

import logging
import math
import re
from concurrent.futures import ThreadPoolExecutor
from typing import Callable, Dict, Mapping, Optional, Sequence, Tuple

import numpy as np
import torch
from torch import nn

__all__ = [
    "init_models",
    "init_weights",
    "load_matched",
    "load_torch_checkpoint",
    "rename_clip_joint_key",
    "rename_clip_key",
    "rename_lgm_key",
    "rename_lpips_key",
    "rename_unet_key",
    "rename_vae_key",
    "state_dict_from_flax",
]

logger = logging.getLogger(__name__)


# ------------------------------------------------------------ released files


def load_torch_checkpoint(path: str) -> Dict[str, torch.Tensor]:
    """A torch ``.pth``/``.bin`` (optionally ``{"state_dict": ...}``) or a
    ``.safetensors`` file as a flat dict of CPU tensors."""
    if path.endswith(".safetensors"):
        from safetensors.torch import load_file

        return dict(load_file(path))
    obj = torch.load(path, map_location="cpu", weights_only=False)
    if isinstance(obj, dict) and "state_dict" in obj:
        obj = obj["state_dict"]
    return {k: v for k, v in obj.items() if isinstance(v, torch.Tensor)}


def rename_unet_key(k: str) -> Optional[str]:
    """UNet ``.pth`` keys: the LGM submodule (``lgm_big.*``) is loaded by
    its own job (``rename_lgm_key``); a ``module.`` (DDP) prefix is
    stripped (JAX ``convert_unet``)."""
    if k.startswith("lgm_big."):
        return None
    return k[len("module."):] if k.startswith("module.") else k


def rename_lgm_key(k: str) -> Optional[str]:
    """LGM keys of ``model.safetensors`` (``unet.down_blocks...``,
    ``conv.weight``) or the ``lgm_big.`` subtree of a UNet checkpoint; the
    LPIPS loss network is not part of it (JAX ``convert_lgm``)."""
    if k.startswith("lgm_big."):
        k = k[len("lgm_big."):]
    return None if "lpips_loss" in k else k


def rename_lpips_key(k: str) -> Optional[str]:
    """LPIPS ``vgg.pth`` keys, in the attribute form (``lin0.model.1.weight``)
    or the ModuleList form (``lins.0.model.1.weight``), with or without the
    ``lpips_loss.`` prefix of an LGM checkpoint; the scaling layer's buffers
    are constants of the module (JAX ``convert_lpips``)."""
    if k.startswith("lpips_loss."):
        k = k[len("lpips_loss."):]
    if k.startswith("scaling_layer."):
        return None
    if k.startswith("lins."):
        idx, rest = k[len("lins."):].split(".", 1)
        k = f"lin{idx}.{rest}"
    return k


def rename_vae_key(k: str) -> Optional[str]:
    """SD VAE keys, ``first_stage_model.`` prefix stripped (JAX ``convert_vae``)."""
    if "first_stage_model" in k:
        k = k.split("first_stage_model.")[-1]
    return None if k.startswith("loss.") else k


def rename_clip_key(k: str) -> Optional[str]:
    """OpenCLIP keys for the text tower: the visual tower and the logit
    scale are not part of it."""
    if k == "logit_scale" or k.startswith("visual."):
        return None
    return k


def rename_clip_joint_key(k: str) -> Optional[str]:
    """OpenCLIP keys for the joint text + visual module
    (``OpenCLIPTextVisual``): everything but the logit scale, under the
    released names (``visual.*`` beside the text tower's keys)."""
    return None if k == "logit_scale" else k


def load_matched(module: nn.Module, sd: Mapping[str, torch.Tensor],
                 rename: Optional[Callable[[str], Optional[str]]] = None) -> dict:
    """Copy the entries of ``sd`` whose (renamed) key and shape match
    ``module``'s state dict; report the rest, as the JAX package's tolerant
    load does. Returns ``{"matched", "missing", "unexpected", "mismatched"}``."""
    target = module.state_dict()
    report = {"matched": [], "missing": [], "unexpected": [], "mismatched": []}
    load = {}
    for key, val in sd.items():
        name = rename(key) if rename is not None else key
        if name is None:
            continue
        if name not in target:
            report["unexpected"].append(key)
        elif tuple(val.shape) != tuple(target[name].shape):
            report["mismatched"].append((key, tuple(val.shape), tuple(target[name].shape)))
        else:
            load[name] = val
            report["matched"].append(key)
    report["missing"] = [k for k in target if k not in load]
    module.load_state_dict(load, strict=False)
    return report


# ---------------------------------------------------------- JAX tree bridge


def _torch_layout(t: np.ndarray, leaf: str, target_shape) -> np.ndarray:
    """Inverse of the JAX package's ``_convert_tensor``."""
    if leaf == "kernel":
        if t.ndim == 2:
            t = t.T  # Dense (I, O) -> Linear (O, I)
            if len(target_shape) == 3:
                t = t[:, :, None]  # ... or a k=1 Conv1d (O, I, 1)
        elif t.ndim == 3:
            t = t.transpose(2, 1, 0)  # (k, I, O) -> (O, I, k)
        elif t.ndim == 4:
            t = t.transpose(3, 2, 0, 1)  # (kh, kw, I, O) -> (O, I, kh, kw)
        elif t.ndim == 5:
            t = t.transpose(4, 3, 0, 1, 2)  # (kt, kh, kw, I, O) -> (O, I, kt, kh, kw)
    return t


def _norm_flax_key(k: str) -> str:
    k = k.replace("/", "_")
    return k[len("params_"):] if k.startswith("params_") else k


def state_dict_from_flax(flat_params: Mapping[str, np.ndarray], module: nn.Module
                         ) -> Dict[str, torch.Tensor]:
    """A ``state_dict`` for ``module`` from a flattened Flax tree.

    ``flat_params`` maps the Flax leaf paths of the module's own tree,
    ``'/'`` or ``'_'`` joined (``input_blocks_1_0/in_layers_2/kernel`` or
    ``input_blocks_1_0_in_layers_2_kernel``; a leading ``params`` is
    ignored), to arrays. ``_kernel``/``_scale``/``_embedding`` leaves become
    ``.weight``; Dense kernels are transposed (and gain a trailing axis
    where the port holds a k=1 Conv1d); conv kernels go HWIO → OIHW (and
    THWIO → OITHW); CLIP q/k/v are packed into ``in_proj_*``. The module's
    own shapes resolve the ambiguous cases. The joint CLIP tree nests its
    towers under ``text`` / ``visual`` where the port (and the released file)
    keeps the text tower's keys at the top level: a tree with ``visual``
    leaves has the ``text`` prefix of its other leaves dropped. A missing,
    unexpected or mismatched key raises."""
    flat = {_norm_flax_key(k): np.asarray(v) for k, v in flat_params.items()}
    if any(k.startswith("visual_") for k in flat):
        flat = {(k[len("text_"):] if k.startswith("text_") else k): v for k, v in flat.items()}
    out: Dict[str, torch.Tensor] = {}
    used = set()
    missing, mismatched = [], []
    for key, ref in module.state_dict().items():
        m = re.match(r"(.*attn)\.in_proj_(weight|bias)$", key)
        if m:
            base, kind = m.group(1).replace(".", "_"), m.group(2)
            names = [f"{base}_{p}_{'kernel' if kind == 'weight' else 'bias'}" for p in "qkv"]
            if not all(n in flat for n in names):
                missing.append(key)
                continue
            used.update(names)
            val = np.concatenate([flat[n].T if kind == "weight" else flat[n] for n in names], 0)
        else:
            base = key.replace(".", "_")
            if base.endswith("_weight"):
                stem = base[: -len("_weight")]
                cands = [(stem + "_kernel", "kernel"), (stem + "_scale", "scale"),
                         (stem + "_embedding", "embedding")]
            elif base.endswith("_bias"):
                cands = [(base, "bias")]
            else:
                cands = [(base, "raw")]
            hit = next(((n, leaf) for n, leaf in cands if n in flat), None)
            if hit is None:
                missing.append(key)
                continue
            used.add(hit[0])
            val = _torch_layout(flat[hit[0]], hit[1], tuple(ref.shape))
        if tuple(val.shape) != tuple(ref.shape):
            mismatched.append((key, tuple(val.shape), tuple(ref.shape)))
            continue
        out[key] = torch.from_numpy(np.array(val, copy=True)).to(ref.dtype)
    unexpected = sorted(set(flat) - used)
    if missing or unexpected or mismatched:
        raise ValueError(
            f"state_dict_from_flax: {len(missing)} missing, {len(unexpected)} unexpected, "
            f"{len(mismatched)} mismatched; e.g. missing={missing[:5]} "
            f"unexpected={unexpected[:5]} mismatched={mismatched[:3]}")
    return out


# ------------------------------------------------------------ initialisation


def _zero_init_names(module: nn.Module) -> set:
    names = set()
    for mname, m in module.named_modules():
        if getattr(m, "zero_init", False):
            for pname, _ in m.named_parameters(recurse=True):
                names.add(f"{mname}.{pname}" if mname else pname)
    return names


@torch.no_grad()
def init_weights(module: nn.Module, seed: int, zero_init: bool = True,
                 device: Optional[torch.device] = None) -> nn.Module:
    """Fill every parameter of ``module`` (in ``named_parameters`` order) from
    numpy ``default_rng(seed)``: weights of rank >= 2 ~ N(0, 1/fan_in) with
    fan_in = prod(shape[1:]); 1-D ``weight`` (norm scales) 1 + 0.1·N(0, 1);
    other 1-D tensors 0.1·N(0, 1). With ``zero_init``, the zero-init layers
    get zeros (their draw is still taken from the stream). A module on the
    meta device is materialised on ``device``.

    numpy fills an array without holding the GIL, so a worker thread draws
    parameter i + 1 while this thread scales parameter i in place (the same
    float32 operations as ``n * s`` and ``1.0 + 0.1 * n``) and copies it."""
    if device is not None:
        module.to_empty(device=device)
    rng = np.random.default_rng(seed)
    zeros = _zero_init_names(module) if zero_init else set()
    params = list(module.named_parameters())

    def draw(i: int) -> np.ndarray:
        return rng.standard_normal(tuple(params[i][1].shape), dtype=np.float32)

    with ThreadPoolExecutor(max_workers=1) as pool:
        ahead = pool.submit(draw, 0) if params else None
        for i, (name, p) in enumerate(params):
            n = ahead.result()
            if i + 1 < len(params):
                ahead = pool.submit(draw, i + 1)
            if name in zeros:
                n[...] = 0.0
            elif n.ndim >= 2:
                n *= np.float32(math.prod(n.shape[1:]) ** -0.5)
            elif name.endswith("weight"):
                n *= np.float32(0.1)
                n += np.float32(1.0)
            else:
                n *= np.float32(0.1)
            p.copy_(torch.from_numpy(n))
    return module


def init_models(jobs: Sequence[Tuple[nn.Module, int]], zero_init: bool = True,
                device: Optional[torch.device] = None) -> None:
    """``init_weights`` of each ``(module, seed)`` in ``jobs``, all at once in
    threads (each module's stream is its own, so the values are those of
    seeding them one after another)."""
    with ThreadPoolExecutor(max_workers=max(len(jobs), 1)) as pool:
        futures = [pool.submit(init_weights, m, seed, zero_init, device) for m, seed in jobs]
        for f in futures:
            f.result()
