"""PDE problem layer. Burgers and KdV are ported; the other PDEs are ROADMAP item 11."""

from pinnrl_tpu_torch.config import Config
from pinnrl_tpu_torch.pdes.base import PDE_CLASSES, PDEBase  # noqa: F401
from pinnrl_tpu_torch.pdes.burgers import BurgersEquation  # noqa: F401
from pinnrl_tpu_torch.pdes.kdv import KdVEquation  # noqa: F401

def create_pde(config: Config) -> PDEBase:
    """Build the PDE problem from a full Config."""
    mode = getattr(config.training, "mode", "forward")
    if mode == "inverse" and not getattr(config.pde, "trainable_parameters", None):
        raise ValueError(
            "inverse mode requires pde.trainable_parameters (use --identify "
            "or set pde.trainable_parameters in the config)"
        )
    return PDEBase.create(config.pde_type, config.pde, config.training)
