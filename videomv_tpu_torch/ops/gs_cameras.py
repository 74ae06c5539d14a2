"""Splat-camera preparation on the device, in plain torch.

Port of ``videomv_tpu/ops/gs_cameras.py``, the device-side re-derivation of
the host prep in ``data/cameras.py::prepare_gs_training``: from the UNet's
16-float camera conditioning it rebuilds, inside the train step, what the
Gaussian renderer and the LGM need — canonicalised poses, Plücker ray
embeddings and the colmap-convention view / view-projection matrices — so
only a 1.5 KB tensor crosses the host→device wire instead of ``[B, F, 6, S,
S]`` fp32 rays. All of it runs in fp32 (plain fp32 matrix products on the
card, no TF32), so it matches the host chain.
"""

from __future__ import annotations

import math

import torch

from ..data.cameras import proj_matrix

__all__ = ["canonical_gs_poses", "colmap_from_poses", "plucker_rays_dev", "proj_matrix"]

# row permutation and sign of the training gs chain: negate row 1, then swap
# rows 1 and 2 (``data.cameras.prepare_gs_training``)
_ROW_PERM = (0, 2, 1, 3)
_ROW_SIGN = (1.0, 1.0, -1.0, 1.0)


def canonical_gs_poses(camera_data: torch.Tensor) -> torch.Tensor:
    """``[B, F, 16]`` camera conditioning → ``[B, F, 4, 4]`` canonicalised
    OpenGL c2w poses: per sample, view 0 lands at (0, 0, cam_dis) looking at
    the origin (left-multiplication by T(z = cam_dis) @ inv(pose 0))."""
    cams = camera_data.reshape(*camera_data.shape[:-1], 4, 4).float()
    sign = torch.tensor(_ROW_SIGN, device=cams.device).reshape(4, 1)
    cams = cams[..., _ROW_PERM, :] * sign
    cam_dis = cams[:, 0, :3, 3].pow(2).sum(-1).sqrt()             # [B]
    t = torch.eye(4, device=cams.device).repeat(cams.shape[0], 1, 1)
    t[:, 2, 3] = cam_dis
    transform = t @ torch.linalg.inv(cams[:, 0])                   # [B, 4, 4]
    return transform[:, None] @ cams


def plucker_rays_dev(poses: torch.Tensor, size: int, fovy_deg: float) -> torch.Tensor:
    """``[..., 4, 4]`` OpenGL poses → ``[..., 6, size, size]`` Plücker
    embeddings (o × d, d) of every pixel's ray."""
    dev = poses.device
    idx = torch.arange(size, device=dev, dtype=torch.float32)
    y, x = torch.meshgrid(idx, idx, indexing="ij")
    cxy = size * 0.5
    focal = size * 0.5 / math.tan(0.5 * math.radians(fovy_deg))
    dirs = torch.stack([(x.reshape(-1) - cxy + 0.5) / focal,
                        -(y.reshape(-1) - cxy + 0.5) / focal,
                        torch.full((size * size,), -1.0, device=dev)], dim=-1)  # [S·S, 3]
    rot = poses[..., :3, :3].float()
    rays_d = torch.einsum("pj,...ij->...pi", dirs, rot)
    rays_d = rays_d / rays_d.norm(dim=-1, keepdim=True).clamp_min(1e-20)
    rays_o = poses[..., None, :3, 3].float().expand_as(rays_d)
    plucker = torch.cat([torch.cross(rays_o, rays_d, dim=-1), rays_d], dim=-1)  # [..., S·S, 6]
    return plucker.transpose(-1, -2).reshape(*poses.shape[:-2], 6, size, size)


def colmap_from_poses(poses: torch.Tensor, proj):
    """Canonicalised poses ``[..., 4, 4]`` → (cam_view, cam_view_proj,
    cam_pos) in the renderer's row-vector colmap convention. ``proj`` is
    ``proj_matrix``'s array (numpy or tensor)."""
    col_sign = torch.ones(4, 4, device=poses.device)
    col_sign[:3, 1:3] = -1.0
    colmap = poses.float() * col_sign
    cam_view = torch.linalg.inv(colmap).transpose(-1, -2)
    cam_view_proj = cam_view @ torch.as_tensor(proj, dtype=torch.float32, device=poses.device)
    return cam_view, cam_view_proj, -colmap[..., :3, 3]
