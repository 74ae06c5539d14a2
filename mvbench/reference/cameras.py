"""Orbit cameras, Plücker rays and splat-camera matrices (numpy only), for
the benchmark's reference: a frozen copy of the camera helpers of the
measured program, so that the reference imports nothing of it.

Parity targets: the reference orbit camera-to-world matrices
(utils/camera_utils.py:4-62, OpenGL look-at with the OpenGL→Blender axis
flip), the inference-time row shuffle (inference_text2video_entrance.py:
184-191), pixel ray casting (core/utils.py:10-43) and the gs-camera chains of
training (video_dataset.py:103-144) and inference
(inference_text2video_entrance.py:196-236).
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Dict

import numpy as np

__all__ = [
    "GSCameraSettings",
    "convert_opengl_to_blender",
    "create_camera_to_world_matrix",
    "get_camera",
    "get_rays",
    "orbit_c2w_opengl",
    "orbit_camera_for_t2v",
    "plucker_rays",
    "prepare_gs_cameras",
    "prepare_gs_training",
    "proj_matrix",
]


def create_camera_to_world_matrix(
    elevation: float, azimuth: float, camera_distance: float = 1.0
) -> np.ndarray:
    """OpenGL-style orbit look-at c2w (utils/camera_utils.py:4-27)."""
    elevation = np.radians(elevation)
    azimuth = np.radians(azimuth)
    x = camera_distance * np.cos(elevation) * np.sin(azimuth)
    y = camera_distance * np.sin(elevation)
    z = camera_distance * np.cos(elevation) * np.cos(azimuth)

    camera_pos = np.array([x, y, z])
    up = np.array([0.0, 1.0, 0.0])
    forward = -camera_pos / np.linalg.norm(camera_pos)
    right = np.cross(forward, up)
    right /= np.linalg.norm(right)
    new_up = np.cross(right, forward)
    new_up /= np.linalg.norm(new_up)
    cam2world = np.eye(4)
    cam2world[:3, :3] = np.stack([right, new_up, -forward], axis=0).T
    cam2world[:3, 3] = camera_pos
    return cam2world


def convert_opengl_to_blender(camera_matrix: np.ndarray) -> np.ndarray:
    flip_yz = np.array(
        [[1, 0, 0, 0], [0, 0, -1, 0], [0, 1, 0, 0], [0, 0, 0, 1]], dtype=camera_matrix.dtype
    )
    return flip_yz @ camera_matrix


def get_camera(
    num_frames: int,
    elevation: float = 15,
    azimuth_start: float = 0,
    azimuth_span: float = 360,
    blender_coord: bool = True,
    camera_distance: float = 1.0,
) -> np.ndarray:
    """[num_frames, 16] flattened orbit c2w matrices (utils/camera_utils.py:46-62)."""
    angle_gap = azimuth_span / num_frames
    cameras = []
    for azimuth in np.arange(azimuth_start, azimuth_span + azimuth_start, angle_gap):
        m = create_camera_to_world_matrix(elevation, azimuth, camera_distance)
        if blender_coord:
            m = convert_opengl_to_blender(m)
        cameras.append(m.flatten())
    return np.stack(cameras, 0).astype(np.float32)


def orbit_camera_for_t2v(num_frames: int = 24, elevation: float = 15,
                         camera_distance: float = 2.0) -> np.ndarray:
    """The UNet's camera conditioning tensor [1, F, 16]
    (inference_text2video_entrance.py:184-191): blender-coord orbit c2w with
    row-1 negated then rows 0/1 swapped."""
    cam = get_camera(num_frames, elevation=elevation, azimuth_start=0,
                     azimuth_span=360, camera_distance=camera_distance)
    cam = cam.reshape(num_frames, 4, 4).copy()
    cam[:, 1, :] *= -1
    cam[:, [0, 1], :] = cam[:, [1, 0], :]
    return cam.reshape(1, num_frames, 16)


def get_rays(pose: np.ndarray, h: int, w: int, fovy: float, opengl: bool = True):
    """Per-pixel ray origins/directions for an OpenGL c2w pose
    (core/utils.py:10-43). Returns (rays_o [h,w,3], rays_d [h,w,3])."""
    x, y = np.meshgrid(np.arange(w), np.arange(h), indexing="xy")
    x = x.flatten().astype(np.float32)
    y = y.flatten().astype(np.float32)

    cx, cy = w * 0.5, h * 0.5
    focal = h * 0.5 / np.tan(0.5 * np.deg2rad(fovy))

    sign = -1.0 if opengl else 1.0
    camera_dirs = np.stack(
        [
            (x - cx + 0.5) / focal,
            (y - cy + 0.5) / focal * sign,
            np.full_like(x, sign),
        ],
        axis=-1,
    )  # [hw, 3]

    rays_d = camera_dirs @ pose[:3, :3].T
    rays_o = np.broadcast_to(pose[:3, 3], rays_d.shape)

    rays_d = rays_d / np.clip(
        np.linalg.norm(rays_d, axis=-1, keepdims=True), 1e-20, None
    )
    return rays_o.reshape(h, w, 3).astype(np.float32), rays_d.reshape(h, w, 3).astype(np.float32)


def plucker_rays(pose: np.ndarray, h: int, w: int, fovy: float) -> np.ndarray:
    """6-channel Plücker embedding [6, h, w]: (o × d, d) (core/models.py:76)."""
    rays_o, rays_d = get_rays(pose, h, w, fovy)
    plucker = np.concatenate([np.cross(rays_o, rays_d, axis=-1), rays_d], axis=-1)
    return plucker.transpose(2, 0, 1).astype(np.float32)


def proj_matrix(fovy_deg: float, znear: float, zfar: float) -> np.ndarray:
    """Row-major perspective matrix (reference core/gs.py:24-29)."""
    tan_half = math.tan(0.5 * math.radians(fovy_deg))
    m = np.zeros((4, 4), dtype=np.float32)
    m[0, 0] = 1.0 / tan_half
    m[1, 1] = 1.0 / tan_half
    m[2, 2] = (zfar + znear) / (zfar - znear)
    m[3, 2] = -(zfar * znear) / (zfar - znear)
    m[2, 3] = 1.0
    return m


@dataclass(frozen=True)
class GSCameraSettings:
    """Splat-camera intrinsics (reference core/options.py 'big' + gs.py:23-29)."""

    fovy: float = 39.6
    znear: float = 0.5
    zfar: float = 2.5
    input_size: int = 256
    output_size: int = 512

    @property
    def tan_half_fov(self) -> float:
        return math.tan(0.5 * math.radians(self.fovy))

    @property
    def proj_matrix(self) -> np.ndarray:
        """Row-major perspective matrix; the reference composes it as
        ``cam_view @ proj`` (row-vector convention)."""
        return proj_matrix(self.fovy, self.znear, self.zfar)


def _gs_matrices(cam_poses: np.ndarray, settings: GSCameraSettings, ray_size: int
                 ) -> Dict[str, np.ndarray]:
    """Plücker rays and colmap-convention view/view-proj matrices of
    canonicalised OpenGL c2w poses [V, 4, 4]."""
    rays = np.stack([plucker_rays(pose, ray_size, ray_size, settings.fovy)
                     for pose in cam_poses], axis=0)
    cam_poses_colmap = cam_poses.copy()
    cam_poses_colmap[:, :3, 1:3] *= -1
    cam_view = np.linalg.inv(cam_poses_colmap).transpose(0, 2, 1)
    cam_view_proj = cam_view @ settings.proj_matrix
    cam_pos = -cam_poses_colmap[:, :3, 3]
    return {
        "input_rays": rays[None],
        "cam_view": cam_view[None].astype(np.float32),
        "cam_view_proj": cam_view_proj[None].astype(np.float32),
        "cam_pos": cam_pos[None].astype(np.float32),
    }


def _canonicalize(cams: np.ndarray) -> np.ndarray:
    """Left-multiply by T(z = cam_dis) @ inv(pose 0): view 0 lands at
    (0, 0, cam_dis) looking at the origin."""
    cam_dis = np.sqrt(np.sum(cams[0, :3, 3] ** 2))
    transform = np.array(
        [[1, 0, 0, 0], [0, 1, 0, 0], [0, 0, 1, cam_dis], [0, 0, 0, 1]],
        dtype=np.float32,
    ) @ np.linalg.inv(cams[0])
    return transform[None] @ cams


def prepare_gs_training(
    c2w_opengl: np.ndarray,
    settings: GSCameraSettings = GSCameraSettings(),
    ray_size: int = 256,
) -> Dict[str, np.ndarray]:
    """The training-side gs camera prep (reference video_dataset.py:103-144),
    the chain the LGM was trained with and the pipeline's default: row-1
    negate + rows-1/2 swap, canonicalise view 0, Plücker rays, colmap
    matrices. ``c2w_opengl``: [V, 4, 4] or [1, V, 16] OpenGL look-at c2w.
    Returns 'input_rays' [1,V,6,h,w], 'cam_view' / 'cam_view_proj'
    [1,V,4,4], 'cam_pos' [1,V,3]."""
    cams = np.asarray(c2w_opengl, dtype=np.float32).reshape(-1, 4, 4).copy()
    cams[:, 1] *= -1
    cams[:, [1, 2]] = cams[:, [2, 1]]
    return _gs_matrices(_canonicalize(cams), settings, ray_size)


def orbit_c2w_opengl(num_frames: int, elevation: float = 15.0,
                     camera_distance: float = 2.0) -> np.ndarray:
    """Raw OpenGL look-at orbit c2w [V, 4, 4] (input to prepare_gs_training)."""
    return np.stack([
        create_camera_to_world_matrix(elevation, az, camera_distance)
        for az in np.arange(0, 360, 360 / num_frames)
    ]).astype(np.float32)


def prepare_gs_cameras(
    camera_data: np.ndarray,
    settings: GSCameraSettings = GSCameraSettings(),
    ray_size: int = 256,
) -> Dict[str, np.ndarray]:
    """The reference inference engine's gs camera prep
    (inference_text2video_entrance.py:196-236), selected by the config key
    ``reference_inference_cameras``. Its extra column flip before
    canonicalisation mirrors the training rig through the z = cam_dis
    plane. ``camera_data``: [1, V, 16] (``orbit_camera_for_t2v``)."""
    gs_camera = camera_data.reshape(-1, 4, 4).astype(np.float32).copy()
    gs_camera[:, 1] *= -1
    gs_camera[:, [1, 2]] = gs_camera[:, [2, 1]]
    gs_camera[:, :3, 1:3] *= -1
    return _gs_matrices(_canonicalize(gs_camera), settings, ray_size)
