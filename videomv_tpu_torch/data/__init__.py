from .cameras import (
    create_camera_to_world_matrix,
    get_camera,
    get_rays,
    orbit_c2w_opengl,
    orbit_camera_for_t2v,
    prepare_gs_cameras,
    prepare_gs_training,
)
from .tokenizer import tokenize

__all__ = ["create_camera_to_world_matrix", "get_camera", "get_rays", "orbit_c2w_opengl",
           "orbit_camera_for_t2v", "prepare_gs_cameras", "prepare_gs_training", "tokenize"]
