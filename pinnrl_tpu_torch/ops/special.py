"""Jacobi elliptic functions and the exact large-amplitude pendulum, as
``pinnrl_tpu.ops.special``: op for op, so float32 inputs give the JAX
function's float32 rounding.

``ellipk`` is the AGM, ``ellipj`` the descending Landen transformation
(Abramowitz & Stegun 16.4) with a fixed ``_N_LANDEN`` levels and no
data-dependent control flow, so both run batched on the device and
differentiate under ``torch.func.jvp`` (the pendulum's velocity target is
a jvp through ``pendulum_theta``). In float32 the error is near 1e-5 for
m <= 0.95; each extra Landen level doubles the seed phase and its rounding.
"""

from __future__ import annotations

import math
from typing import Tuple

import torch

# Quadratic convergence: c_6 < 1e-12 for any m <= 0.95; every extra level
# doubles the seed phase phi_N = 2^N a_N u and with it the f32 rounding.
_N_LANDEN = 6


def ellipk(m) -> torch.Tensor:
    """Complete elliptic integral of the first kind K(m), m = k^2, via AGM."""
    m = torch.as_tensor(m)
    a = torch.ones_like(m)
    b = torch.sqrt(1.0 - m)
    for _ in range(_N_LANDEN):
        a, b = (a + b) / 2.0, torch.sqrt(a * b)
    # Not ``math.pi / (2 a)``: torch divides a Python scalar by a tensor as
    # reciprocal then product, two roundings where jnp has one.
    return torch.full_like(a, math.pi) / (2.0 * a)


def ellipj(u, m) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Jacobi elliptic sn(u|m), cn(u|m), dn(u|m), m = k^2 in [0, 1).

    The AGM ladder a_{n+1} = (a_n + b_n)/2, b_{n+1} = sqrt(a_n b_n),
    c_{n+1} = (a_n - b_n)/2, the seed phi_N = 2^N a_N u, then
    phi_{n-1} = (phi_n + arcsin((c_n / a_n) sin phi_n)) / 2; sn = sin phi_0,
    cn = cos phi_0, dn = cos phi_0 / cos(phi_1 - phi_0). ``u`` is first
    reduced into one period 4K (``torch.round``, like ``jnp.round``, rounds
    half to even). A Python ``m`` becomes a 0-d tensor on the host, so the
    ladder runs there and a device ``u`` meets it as a scalar (no copy to
    the device inside a step).
    """
    u = torch.as_tensor(u)
    m = m if isinstance(m, torch.Tensor) else torch.tensor(m, dtype=u.dtype)
    period = 4.0 * ellipk(m)
    u = u - period * torch.round(u / period)
    a = torch.ones_like(m)
    b = torch.sqrt(1.0 - m)
    c = torch.sqrt(m)
    ladder = []
    for _ in range(_N_LANDEN):
        a, b, c = (a + b) / 2.0, torch.sqrt(a * b), (a - b) / 2.0
        ladder.append((a, c))
    phi = (2.0**_N_LANDEN) * a * u  # phi_N
    phi_1 = phi
    for a_n, c_n in reversed(ladder):  # n = N, N-1, ..., 1
        phi_1 = phi  # on the final pass this holds phi_1
        phi = (phi + torch.arcsin(torch.clamp(c_n / a_n * torch.sin(phi), -1.0, 1.0))) / 2.0
    sn = torch.sin(phi)
    cn = torch.cos(phi)
    dn = cn / torch.cos(phi_1 - phi)
    # m = 0 degenerates to circular functions with dn = 1 exactly.
    if m.device == dn.device:
        dn = torch.where(m == 0.0, torch.ones_like(dn), dn)
    elif bool(m == 0.0):  # a host scalar m beside device u: decided on the host
        dn = torch.ones_like(dn)
    return sn, cn, dn


def pendulum_theta(t, theta0, omega):
    """The pendulum released from rest at ``theta0``:
    theta'' + omega^2 sin(theta) = 0 gives theta(t) = 2 arcsin(k cd(omega t | m)),
    k = sin(theta0 / 2), m = k^2, cd = cn / dn."""
    t = torch.as_tensor(t)
    k = torch.sin(torch.tensor(theta0 / 2.0, dtype=t.dtype))  # on the host
    m = k * k
    sn, cn, dn = ellipj(omega * t, m)
    return 2.0 * torch.arcsin(torch.clamp(k * cn / dn, -1.0, 1.0))
