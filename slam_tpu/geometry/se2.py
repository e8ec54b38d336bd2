"""SE(2) manifold operations and pose-graph edge residuals.

Design notes
------------
The reference (DCS-ceres) builds 3x3 homogeneous matrices per pose and
multiplies/inverts them inside an autodiff functor
(``DCS-ceres/src/ceres_error.cpp:42-94``).  Here we instead
work in closed form on ``(..., 3)`` arrays ``[x, y, theta]``: every operation
below is a handful of fused element-wise ops, maps over arbitrary batch
dimensions, and never materialises matrices.  Jacobians are analytic (3x3 per
endpoint), validated in tests against ``jax.jacfwd`` of :func:`residual`.

Residual semantics match the reference bit-for-bit in exact arithmetic
(``ceres_error.cpp:87-91``):

    diff = Tcap^-1 (Ta^-1 Tb)
    e = [diff(0,2), diff(1,2), asin(diff(1,0))]

i.e. the angle error is ``asin(sin(tb - ta - tm))`` -- the reference's sawtooth
folding (NOT a wrap to [-pi, pi]).  We reproduce it exactly, including its
quirk that an angle error of pi has zero cost, because the correctness gate is
matching the reference's fixed points.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

Array = jax.Array


def compose(p: Array, q: Array) -> Array:
    """SE(2) composition ``p . q`` for pose arrays ``[..., 3]``."""
    x, y, t = p[..., 0], p[..., 1], p[..., 2]
    qx, qy, qt = q[..., 0], q[..., 1], q[..., 2]
    c, s = jnp.cos(t), jnp.sin(t)
    return jnp.stack(
        [x + c * qx - s * qy, y + s * qx + c * qy, t + qt], axis=-1
    )


def inverse(p: Array) -> Array:
    """SE(2) inverse for pose arrays ``[..., 3]``."""
    x, y, t = p[..., 0], p[..., 1], p[..., 2]
    c, s = jnp.cos(t), jnp.sin(t)
    return jnp.stack([-(c * x + s * y), -(-s * x + c * y), -t], axis=-1)


def relative(pa: Array, pb: Array) -> Array:
    """``Ta^-1 Tb`` -- pose of ``b`` in the frame of ``a``."""
    dx = pb[..., 0] - pa[..., 0]
    dy = pb[..., 1] - pa[..., 1]
    ca, sa = jnp.cos(pa[..., 2]), jnp.sin(pa[..., 2])
    return jnp.stack(
        [ca * dx + sa * dy, -sa * dx + ca * dy, pb[..., 2] - pa[..., 2]],
        axis=-1,
    )


def wrap_angle(t: Array) -> Array:
    """Wrap angle(s) to ``[-pi, pi)``."""
    return jnp.mod(t + jnp.pi, 2.0 * jnp.pi) - jnp.pi


def fold_angle(t: Array) -> Array:
    """The reference's ``asin(sin(t))`` sawtooth fold to ``[-pi/2, pi/2]``.

    Clamps the sine into [-1, 1] like ``layer_manager.cpp:226`` so the fold is
    NaN-free in low precision.
    """
    return jnp.arcsin(jnp.clip(jnp.sin(t), -1.0, 1.0))


def residual(pa: Array, pb: Array, meas: Array) -> Array:
    """Edge residual ``e(pa, pb; meas)`` with reference semantics.

    ``e01`` is the translation part of ``Tcap^-1 (Ta^-1 Tb)`` and ``e2`` is
    ``asin(sin(tb - ta - tm))`` (``ceres_error.cpp:87-91``).  Works over any
    batch shape.
    """
    rel = relative(pa, pb)
    mx, my, mt = meas[..., 0], meas[..., 1], meas[..., 2]
    cm, sm = jnp.cos(mt), jnp.sin(mt)
    vx = rel[..., 0] - mx
    vy = rel[..., 1] - my
    e0 = cm * vx + sm * vy
    e1 = -sm * vx + cm * vy
    e2 = fold_angle(rel[..., 2] - mt)
    return jnp.stack([e0, e1, e2], axis=-1)


def residual_and_jacobians(
    pa: Array, pb: Array, meas: Array
) -> tuple[Array, Array, Array]:
    """Residual plus analytic 3x3 Jacobians wrt ``pa`` and ``pb``.

    Replaces the reference's Ceres ``AutoDiffCostFunction`` Jet evaluation
    (``ceres_error.cpp:34``) with closed-form derivatives.

    Derivation: with ``u = tb_xy - ta_xy``, ``v = R(-ta) u``,
    ``e01 = R(-tm) (v - m_xy)``:

        d e01 / d ta_xy = -R(-tm) R(-ta)
        d e01 / d ta_t  =  R(-tm) dR(-t)/dt|_{ta} u
        d e01 / d tb_xy =  R(-tm) R(-ta)
        d e2  / d tb_t  =  sign(cos(dt)),  d e2 / d ta_t = -sign(cos(dt))

    where ``dt = tb_t - ta_t - tm`` and ``d asin(sin x)/dx = sgn(cos x)``.
    Returns ``(e, Ja, Jb)`` with shapes ``[..., 3]``, ``[..., 3, 3]``.
    """
    dtype = pa.dtype
    ta = pa[..., 2]
    ca, sa = jnp.cos(ta), jnp.sin(ta)
    mt = meas[..., 2]
    cm, sm = jnp.cos(mt), jnp.sin(mt)
    dx = pb[..., 0] - pa[..., 0]
    dy = pb[..., 1] - pa[..., 1]

    vx = ca * dx + sa * dy
    vy = -sa * dx + ca * dy
    wx = vx - meas[..., 0]
    wy = vy - meas[..., 1]
    e0 = cm * wx + sm * wy
    e1 = -sm * wx + cm * wy
    dt = pb[..., 2] - ta - mt
    sdt = jnp.sin(dt)
    e2 = jnp.arcsin(jnp.clip(sdt, -1.0, 1.0))
    e = jnp.stack([e0, e1, e2], axis=-1)

    # Rm = R(-tm) R(-ta): rotation by -(tm + ta).
    cma = jnp.cos(mt + ta)
    sma = jnp.sin(mt + ta)

    # dv/dta_t = [[-sa, ca], [-ca, -sa]] @ u
    gx = -sa * dx + ca * dy
    gy = -ca * dx - sa * dy
    # de01/dta_t = R(-tm) @ g
    ht_x = cm * gx + sm * gy
    ht_y = -sm * gx + cm * gy

    # sign of cos(dt); at |cos|=0 the true derivative is unbounded -- use the
    # clamp's subgradient 0 there is unnecessary, sign(0)=0 is a safe choice.
    sgn = jnp.sign(jnp.cos(dt))

    zeros = jnp.zeros_like(e0)
    # R(-tm) R(-ta) = R(-(tm+ta)) = [[cma, sma], [-sma, cma]];
    # d e01/d ta_xy = -R(-(tm+ta)), d e01/d tb_xy = +R(-(tm+ta)).
    # Ja rows: d e_i / d (xa, ya, ta)
    Ja = jnp.stack(
        [
            jnp.stack([-cma, -sma, ht_x], axis=-1),
            jnp.stack([sma, -cma, ht_y], axis=-1),
            jnp.stack([zeros, zeros, -sgn], axis=-1),
        ],
        axis=-2,
    )
    Jb = jnp.stack(
        [
            jnp.stack([cma, sma, zeros], axis=-1),
            jnp.stack([-sma, cma, zeros], axis=-1),
            jnp.stack([zeros, zeros, sgn], axis=-1),
        ],
        axis=-2,
    )
    return e.astype(dtype), Ja.astype(dtype), Jb.astype(dtype)


def retract(p: Array, delta: Array) -> Array:
    """Additive retraction used by the reference (raw ``double[3]`` params).

    Ceres optimises the raw parameter vector without a local parameterization
    (``main.cpp:99`` passes bare pointers), so the update is plain addition.
    """
    return p + delta


def ate(poses: Array, ref: Array, align: bool = True) -> Array:
    """Absolute trajectory error (RMSE over xy) after optional SE(2) alignment.

    With ``align=True`` the best-fit rigid transform (Umeyama, no scale) is
    removed first, so gauge freedom does not pollute the metric.
    """
    p = poses[..., :2]
    q = ref[..., :2]
    if align:
        pm = p.mean(axis=0)
        qm = q.mean(axis=0)
        pc = p - pm
        qc = q - qm
        # 2D Umeyama without reflection handling via atan2 of cross/dot sums.
        sxx = jnp.sum(pc[:, 0] * qc[:, 0] + pc[:, 1] * qc[:, 1])
        sxy = jnp.sum(pc[:, 0] * qc[:, 1] - pc[:, 1] * qc[:, 0])
        th = jnp.arctan2(sxy, sxx)
        c, s = jnp.cos(th), jnp.sin(th)
        p = jnp.stack(
            [c * pc[:, 0] - s * pc[:, 1], s * pc[:, 0] + c * pc[:, 1]],
            axis=-1,
        ) + qm
    d = p - q
    return jnp.sqrt(jnp.mean(jnp.sum(d * d, axis=-1)))
