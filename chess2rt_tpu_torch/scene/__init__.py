from .loader import parse_scene_from_file, parse_scene_from_string  # noqa: F401
