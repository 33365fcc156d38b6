"""Metadata registry for "The Well" benchmark datasets, as
``pinnrl_tpu.datasets.registry`` (a copy: the port imports nothing of the
JAX package).

Each entry carries the defaults that wire a Well dataset into training
(spatial dims, field channels, domain, recommended architecture and mode),
one table row per dataset, expanded into frozen ``WellEntry`` dataclasses
at import; ``synthetic_heat_2d`` is the offline stand-in
(``datasets/synthetic.py``).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple


@dataclass(frozen=True)
class WellEntry:
    name: str
    description: str
    n_spatial_dims: int
    fields: Tuple[str, ...]
    domain: Tuple[Tuple[float, float], ...]
    time_domain: Tuple[float, float]
    default_pde_key: Optional[str]
    default_architecture: str
    default_input_dim: int
    default_output_dim: int
    recommended_mode: str

    def __post_init__(self) -> None:
        if self.n_spatial_dims not in (2, 3):
            raise ValueError(f"{self.name}: n_spatial_dims must be 2 or 3")
        if len(self.domain) != self.n_spatial_dims:
            raise ValueError(f"{self.name}: domain axes != n_spatial_dims")
        if self.recommended_mode not in ("data_only", "data_augmented"):
            raise ValueError(f"{self.name}: bad recommended_mode")
        if self.recommended_mode == "data_augmented" and self.default_pde_key is None:
            raise ValueError(f"{self.name}: data_augmented needs a default_pde_key")
        if self.default_input_dim != self.n_spatial_dims + 1:
            raise ValueError(f"{self.name}: input_dim must be n_spatial_dims+1")
        if self.default_output_dim != len(self.fields):
            raise ValueError(f"{self.name}: output_dim must equal len(fields)")


_U2 = ((0.0, 1.0), (0.0, 1.0))
_U3 = ((0.0, 1.0), (0.0, 1.0), (0.0, 1.0))

# (name, description, dims, fields, domain, pde_key, arch, mode)
_ROWS = [
    (
        "active_matter",
        "2D active nematic fluid: concentration, velocity, orientation, strain rate.",
        2,
        ("concentration", "velocity_x", "velocity_y",
         "orientation_xx", "orientation_xy", "orientation_yx", "orientation_yy",
         "strain_rate_xx", "strain_rate_xy", "strain_rate_yx", "strain_rate_yy"),
        _U2, None, "fno", "data_only",
    ),
    (
        "rayleigh_benard",
        "2D Rayleigh-Benard convection cell driven by a bottom-heated plate.",
        2, ("buoyancy", "pressure", "velocity_x", "velocity_y"),
        ((0.0, 4.0), (0.0, 1.0)), None, "fno", "data_only",
    ),
    (
        "shear_flow",
        "2D incompressible shear flow (Kelvin-Helmholtz roll-up).",
        2, ("tracer", "pressure", "velocity_x", "velocity_y"),
        ((0.0, 1.0), (0.0, 2.0)), None, "fno", "data_only",
    ),
    (
        "rayleigh_taylor_instability",
        "3D Rayleigh-Taylor instability: a heavy fluid fingering into a light one.",
        3, ("density", "pressure", "velocity_x", "velocity_y", "velocity_z"),
        _U3, None, "feedforward", "data_only",
    ),
    (
        "turbulent_radiative_layer_2D",
        "2D astrophysical mixing layer where turbulence competes with radiative cooling.",
        2, ("density", "pressure", "velocity_x", "velocity_y"),
        ((0.0, 1.0), (0.0, 0.5)), None, "fno", "data_only",
    ),
    (
        "MHD_64",
        "Turbulent 3D MHD box (64^3 grid): coupled velocity and magnetic fields.",
        3,
        ("density", "velocity_x", "velocity_y", "velocity_z",
         "magnetic_x", "magnetic_y", "magnetic_z"),
        _U3, None, "feedforward", "data_only",
    ),
    (
        "gray_scott_reaction_diffusion",
        "Two-species Gray-Scott system in 2D: self-organizing spot/stripe patterns.",
        2, ("A", "B"), _U2, None, "fno", "data_only",
    ),
    (
        "euler_multi_quadrants_periodicBC",
        "Gas dynamics: four-quadrant Riemann problems for the compressible "
        "Euler equations on a periodic 2D box.",
        2, ("density", "pressure", "velocity_x", "velocity_y"),
        _U2, None, "fno", "data_only",
    ),
    (
        "viscoelastic_instability",
        "Elastic-turbulence regime of a 2D viscoelastic channel flow (conformation tensor + velocity).",
        2, ("c_xx", "c_xy", "c_yy", "pressure", "velocity_x", "velocity_y"),
        _U2, None, "fno", "data_only",
    ),
    (
        "acoustic_scattering_maze",
        "Pressure waves threading a 2D maze of rigid walls (acoustic scattering).",
        2, ("pressure", "velocity_x", "velocity_y"),
        _U2, "wave", "fno", "data_augmented",
    ),
    (
        "helmholtz_staircase",
        "Time-harmonic (Helmholtz) field over a 2D staircase boundary, real+imaginary parts.",
        2, ("real", "imaginary"), _U2, "wave", "fno", "data_augmented",
    ),
    (
        "planetswe",
        "Rotating shallow-water flow over a full planetary sphere "
        "(lon/lat grid, global circulation scales).",
        2, ("height", "velocity_lon", "velocity_lat"),
        ((0.0, 360.0), (-90.0, 90.0)), None, "fno", "data_only",
    ),
]

WELL_REGISTRY: Dict[str, WellEntry] = {
    name: WellEntry(
        name=name,
        description=desc,
        n_spatial_dims=dims,
        fields=fields,
        domain=domain,
        time_domain=(0.0, 1.0),
        default_pde_key=pde_key,
        default_architecture=arch,
        default_input_dim=dims + 1,
        default_output_dim=len(fields),
        recommended_mode=mode,
    )
    for name, desc, dims, fields, domain, pde_key, arch, mode in _ROWS
}


# Offline synthetic stand-in (NOT a Well dataset): exact 2D heat-kernel
# trajectories generated locally (datasets/synthetic.py) so the full Well
# pipeline — registry -> loader cache -> data-mode training -> FNO operator
# benchmark — runs end-to-end in zero-egress environments. Clearly named so
# it can never be mistaken for Well data.
WELL_REGISTRY["synthetic_heat_2d"] = WellEntry(
    name="synthetic_heat_2d",
    description=(
        "Synthetic (locally generated) 2D heat-kernel modes on [0, pi]^2 — "
        "offline stand-in exercising the exact Well data path."
    ),
    n_spatial_dims=2,
    fields=("temperature",),
    domain=((0.0, 3.14159265358979), (0.0, 3.14159265358979)),
    time_domain=(0.0, 1.0),
    default_pde_key="heat_2d",
    default_architecture="fno",
    default_input_dim=3,
    default_output_dim=1,
    recommended_mode="data_only",
)


def list_dataset_names() -> List[str]:
    return sorted(WELL_REGISTRY)


def get_entry(name: str) -> WellEntry:
    if name not in WELL_REGISTRY:
        raise KeyError(
            f"Unknown Well dataset {name!r}. Known: {', '.join(list_dataset_names())}"
        )
    return WELL_REGISTRY[name]
