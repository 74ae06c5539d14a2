from .seed import setup_seed
from .video_io import save_multiview_video

__all__ = ["save_multiview_video", "setup_seed"]
