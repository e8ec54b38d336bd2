"""Robust kernels: Huber loss, Dynamic Covariance Scaling, switchable weights.

The reference applies robustness in two distinct places:

* A Ceres ``HuberLoss(0.01)`` wraps *every* residual block
  (``DCS-ceres/main.cpp:68``).  Ceres defines the total cost
  as ``0.5 * sum_i rho_i(|r_i|^2)``; we reproduce ``rho`` exactly and use the
  standard IRLS square-root reweighting ``sqrt(rho'(s))`` when linearising.
* DCS scales the closure residual *inside* the autodiff functor with
  ``psi = min(1, sqrt(2*phi / (phi + ex^2 + ey^2)))`` and ``phi = 0.5``
  (``ceres_error.cpp:185-193``), so the Jacobian differentiates *through*
  ``psi``.  :func:`dcs_scale` reproduces that exactly, including the chain
  rule, so our Gauss-Newton system matches Ceres' linearisation of the DCS
  residual (up to the Jet-vs-analytic equivalence).

Everything is pure element-wise math over batched arrays -- fusable, no
data-dependent control flow.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

Array = jax.Array


def huber_rho(s: Array, delta: float) -> Array:
    """Ceres ``HuberLoss(delta)``: rho(s) for squared norm ``s = |r|^2``.

    rho(s) = s                      if s <= delta^2
           = 2*delta*sqrt(s) - delta^2   otherwise
    """
    d2 = delta * delta
    # sqrt guarded so the inactive branch never produces NaN gradients.
    safe = jnp.sqrt(jnp.maximum(s, d2))
    return jnp.where(s <= d2, s, 2.0 * delta * safe - d2)


def huber_weight(s: Array, delta: float) -> Array:
    """IRLS weight ``rho'(s)``: 1 inside the quadratic region, delta/|r| out."""
    d2 = delta * delta
    safe = jnp.sqrt(jnp.maximum(s, d2))
    return jnp.where(s <= d2, jnp.ones_like(s), delta / safe)


def dcs_psi(e: Array, phi: float, dims: int = 2) -> Array:
    """DCS scale ``psi`` from the translational part of the residual.

    Matches ``ceres_error.cpp:186-188``: ``res = ex^2 + ey^2`` (the angle
    term is excluded), ``psi = min(1, sqrt(2*phi/(phi + res)))``.  ``dims``
    selects how many leading residual components feed ``res`` (2 for SE(2),
    3 for the SE(3) extension).
    """
    res = jnp.sum(e[..., :dims] ** 2, axis=-1)
    psi = jnp.sqrt(2.0 * phi / (phi + res))
    return jnp.minimum(1.0, psi)


def dcs_scale(
    e: Array, Ja: Array, Jb: Array, phi: float, dims: int = 2
) -> tuple[Array, Array, Array]:
    """Scale residual and Jacobians by DCS psi, differentiating through psi.

    With ``r = ex^2 + ey^2`` and ``psi(r)``:

        d(psi*e)/dx = psi * J + e (x) (dpsi/dr * dr/dx)
        dr/dx = 2*(e0 * J[0,:] + e1 * J[1,:])
        dpsi/dr = -psi / (2*(phi + r))   when psi < 1, else 0

    Shapes: ``e [...,3]``, ``Ja/Jb [...,3,3]``.
    """
    r = jnp.sum(e[..., :dims] ** 2, axis=-1)
    psi_raw = jnp.sqrt(2.0 * phi / (phi + r))
    active = psi_raw < 1.0
    psi = jnp.where(active, psi_raw, 1.0)
    dpsi_dr = jnp.where(active, -psi / (2.0 * (phi + r)), 0.0)

    def scale_jac(J: Array) -> Array:
        # dr/dx = 2 * sum_k e_k J[k, :] over the translational components.
        drdx = 2.0 * jnp.einsum(
            "...k,...kj->...j", e[..., :dims], J[..., :dims, :]
        )
        return psi[..., None, None] * J + (
            e[..., :, None] * (dpsi_dr[..., None] * drdx)[..., None, :]
        )

    return psi[..., None] * e, scale_jac(Ja), scale_jac(Jb)


def switch_scale(
    e: Array, Ja: Array, Jb: Array, s: Array
) -> tuple[Array, Array, Array, Array]:
    """Switchable-constraints scaling ``s * e`` (Sunderhauf IROS'12).

    Matches ``ceres_error.cpp:287-289``.  Returns the scaled residual, scaled
    pose Jacobians, and the Jacobian wrt the switch variable, ``de/ds = e``.
    """
    se = s[..., None] * e
    return (
        se,
        s[..., None, None] * Ja,
        s[..., None, None] * Jb,
        e,  # d(s*e)/ds
    )


def switch_prior_residual(s: Array, lam: float) -> Array:
    """Prior residual ``sqrt(lambda) * (1 - s)`` (``ceres_error.cpp:315``)."""
    return jnp.sqrt(lam) * (1.0 - s)


def sc_varpro_scale(
    e: Array, Ja: Array, Jb: Array, lam: float
) -> tuple[Array, Array, Array]:
    """Variable-projection switchable constraints.

    The reference optimises the switch ``s`` jointly with the poses
    (``main.cpp:115-125``); but for fixed poses the optimal switch of
    ``0.5 |s e|^2 + 0.5 lam (1-s)^2`` has the closed form

        s*(r2) = lam / (lam + r2),   r2 = |e|^2,

    so the switches can be *eliminated* (variable projection): substitute
    ``s*`` and differentiate through it, exactly as DCS differentiates
    through psi.  This is the classical Black-Rangarajan equivalence of
    switchable constraints with a Geman-McClure kernel -- and unlike the
    reference's joint formulation (whose Huber wrapper keeps switches near
    1), it actually drives outlier weights toward 0.

    Chain rule: with ``psi = s*``, ``dpsi/dr2 = -psi^2 / lam``:

        d(psi e)/dx = psi J + e (dpsi/dr2) (2 e^T J)
    """
    r2 = jnp.sum(e * e, axis=-1)
    psi = lam / (lam + r2)
    dpsi = -psi * psi / lam

    def scale_jac(J: Array) -> Array:
        drdx = 2.0 * jnp.einsum("...k,...kj->...j", e, J)
        return psi[..., None, None] * J + (
            e[..., :, None] * (dpsi[..., None] * drdx)[..., None, :]
        )

    return psi[..., None] * e, scale_jac(Ja), scale_jac(Jb)


def sc_varpro_switch(e: Array, lam: float) -> Array:
    """The eliminated switch values ``s*`` (for reporting/switches.txt)."""
    return lam / (lam + jnp.sum(e * e, axis=-1))
