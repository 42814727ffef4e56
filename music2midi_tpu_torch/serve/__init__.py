from .webui_utils import post_process, video_stream_present  # noqa: F401
