from .seed import setup_seed
from .video_io import save_multiview_video, save_video_grid

__all__ = ["save_multiview_video", "save_video_grid", "setup_seed"]
