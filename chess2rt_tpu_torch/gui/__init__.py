from .session import CONTROLS, InteractiveSession

__all__ = ["InteractiveSession", "CONTROLS"]
