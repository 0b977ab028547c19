from . import color, vec  # noqa: F401
