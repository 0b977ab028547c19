from .renderer import OracleRenderer, render_scene

__all__ = ["OracleRenderer", "render_scene"]
