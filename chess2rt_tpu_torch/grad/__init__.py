from .checkpoint import load_checkpoint, save_checkpoint
from .inverse import InverseProblem, fit

__all__ = ["InverseProblem", "fit", "save_checkpoint", "load_checkpoint"]
