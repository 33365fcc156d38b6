"""PDE problem layer: every PDE of the JAX package. Burgers, KdV (direct and
first-order forms), heat (``heat_2d`` included), convection, Allen-Cahn and
Cahn-Hilliard (direct and mixed forms; both with their spectral dynamics
targets), Black-Scholes, wave and the pendulum (with its Jacobi-elliptic
exact solution). ``PDE_REGISTRY`` carries the display names the training
CLI accepts."""

from pinnrl_tpu_torch.config import Config
from pinnrl_tpu_torch.pdes.base import PDE_CLASSES, PDEBase  # noqa: F401
from pinnrl_tpu_torch.pdes.allen_cahn import AllenCahnEquation  # noqa: F401
from pinnrl_tpu_torch.pdes.black_scholes import BlackScholesEquation  # noqa: F401
from pinnrl_tpu_torch.pdes.burgers import BurgersEquation  # noqa: F401
from pinnrl_tpu_torch.pdes.cahn_hilliard import CahnHilliardEquation  # noqa: F401
from pinnrl_tpu_torch.pdes.convection import ConvectionEquation  # noqa: F401
from pinnrl_tpu_torch.pdes.heat import HeatEquation  # noqa: F401
from pinnrl_tpu_torch.pdes.kdv import KdVEquation  # noqa: F401
from pinnrl_tpu_torch.pdes.pendulum import PendulumEquation  # noqa: F401
from pinnrl_tpu_torch.pdes.wave import WaveEquation  # noqa: F401
PDE_REGISTRY = {
    "heat": "Heat Equation",
    "heat_2d": "2D Heat Equation",
    "wave": "Wave Equation",
    "burgers": "Burgers Equation",
    "convection": "Convection Equation",
    "kdv": "KdV Equation",
    "allen_cahn": "Allen-Cahn Equation",
    "cahn_hilliard": "Cahn-Hilliard Equation",
    "black_scholes": "Black-Scholes Equation",
    "pendulum": "Pendulum Equation",
}


def create_pde(config: Config) -> PDEBase:
    """Build the PDE problem from a full Config."""
    mode = getattr(config.training, "mode", "forward")
    if mode == "inverse" and not getattr(config.pde, "trainable_parameters", None):
        raise ValueError(
            "inverse mode requires pde.trainable_parameters (use --identify "
            "or set pde.trainable_parameters in the config)"
        )
    return PDEBase.create(config.pde_type, config.pde, config.training, device=config.device)
