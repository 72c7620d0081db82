"""The Preetham sky baked to a lat-long image and the sun's radiance (host
numpy; a copy of zyg_tpu/scene/sky.py:15-133, whose arrays it reproduces
exactly).

The reference bakes the Prague sky model from a dataset; the JAX package
bakes the Preetham, Shirley & Smits 1999 analytic model instead (published
closed-form fits, no dataset) into a lat-long emission texture for a Dome
light, plus a Distant sun of atmosphere-attenuated radiance, and the port
keeps that (scene/loader.py's Sky entity).
"""

from __future__ import annotations

import numpy as np

SUN_ANGULAR_RADIUS = 0.00465  # rad, ~0.266 deg (ref sky/sun constants)


def _perez(theta, gamma, coeff):
    a, b, c, d, e = coeff
    cos_t = np.maximum(np.cos(theta), 0.01)
    cg = np.cos(gamma)
    return (1.0 + a * np.exp(b / cos_t)) * (1.0 + c * np.exp(d * gamma) + e * cg * cg)


def _preetham_coeffs(t):
    """Perez coefficients for Y, x, y as functions of turbidity."""
    cy = (0.1787 * t - 1.4630, -0.3554 * t + 0.4275, -0.0227 * t + 5.3251,
          0.1206 * t - 2.5771, -0.0670 * t + 0.3703)
    cx = (-0.0193 * t - 0.2592, -0.0665 * t + 0.0008, -0.0004 * t + 0.2125,
          -0.0641 * t - 0.8989, -0.0033 * t + 0.0452)
    cyy = (-0.0167 * t - 0.2608, -0.0950 * t + 0.0092, -0.0079 * t + 0.2102,
           -0.0441 * t - 1.6537, -0.0109 * t + 0.0529)
    return cy, cx, cyy


def _zenith_values(t, theta_s):
    chi = (4.0 / 9.0 - t / 120.0) * (np.pi - 2.0 * theta_s)
    yz = (4.0453 * t - 4.9710) * np.tan(chi) - 0.2155 * t + 2.4192  # kcd/m^2
    yz = max(yz, 0.0)
    ts2, ts3 = theta_s * theta_s, theta_s**3
    tv = np.array([ts3, ts2, theta_s, 1.0])
    xz = np.array(
        [[0.00166, -0.00375, 0.00209, 0.0],
         [-0.02903, 0.06377, -0.03202, 0.00394],
         [0.11693, -0.21196, 0.06052, 0.25886]]
    )
    yzc = np.array(
        [[0.00275, -0.00610, 0.00317, 0.0],
         [-0.04214, 0.08970, -0.04153, 0.00516],
         [0.15346, -0.26756, 0.06670, 0.26688]]
    )
    tvec = np.array([t * t, t, 1.0])
    x_z = tvec @ (xz @ tv)
    y_z = tvec @ (yzc @ tv)
    return yz, x_z, y_z


def _yxy_to_rgb(Y, x, y):
    y = np.maximum(y, 1e-6)
    X = x / y * Y
    Z = (1.0 - x - y) / y * Y
    xyz = np.stack([X, Y, Z], axis=-1)
    m = np.array(
        [[3.2404542, -1.5371385, -0.4985314],
         [-0.9692660, 1.8760108, 0.0415560],
         [0.0556434, -0.2040259, 1.0572252]], np.float32)
    return np.maximum(xyz @ m.T, 0.0)


def bake_sky(sun_dir, turbidity: float = 2.5, width: int = 512, height: int = 256,
             exposure_scale: float = 0.025) -> np.ndarray:
    """Lat-long [H,W,3] linear radiance of the Preetham sky.

    sun_dir: direction the sun LIGHT TRAVELS (pointing down into the scene).
    uv convention matches the Dome fragment: u = atan2(x,z)/2pi + 0.5,
    v = acos(y)/pi. exposure_scale maps kcd/m^2 into the renderer's linear
    radiance units (the reference's Prague model is absolute; scenes balance
    exposure via tonemapping either way)."""
    to_sun = -np.asarray(sun_dir, np.float64)
    to_sun = to_sun / np.linalg.norm(to_sun)
    theta_s = np.arccos(np.clip(to_sun[1], -1.0, 1.0))
    theta_s = min(theta_s, np.pi / 2 - 0.001)

    cy, cx, cyy = _preetham_coeffs(turbidity)
    yz, xz, yyz = _zenith_values(turbidity, theta_s)

    u = (np.arange(width) + 0.5) / width
    v = (np.arange(height) + 0.5) / height
    U, V = np.meshgrid(u, v)
    phi = (U - 0.5) * 2.0 * np.pi
    theta = V * np.pi
    dirs = np.stack(
        [np.sin(theta) * np.sin(phi), np.cos(theta), np.sin(theta) * np.cos(phi)], -1
    )
    theta_v = np.minimum(theta, np.pi / 2 - 0.001)
    cos_gamma = np.clip(dirs @ to_sun, -1.0, 1.0)
    gamma = np.arccos(cos_gamma)

    def ratio(coeff, zen):
        denom = _perez(np.array(0.0), np.array(theta_s), coeff)
        return zen * _perez(theta_v, gamma, coeff) / max(denom, 1e-9)

    Y = ratio(cy, yz)
    x = ratio(cx, xz)
    yy = ratio(cyy, yyz)
    rgb = _yxy_to_rgb(Y * exposure_scale, x, yy).astype(np.float32)
    # fade below the horizon to ground albedo-ish haze
    below = dirs[..., 1] < 0.0
    horizon_mean = rgb[np.clip((height // 2) - 1, 0, height - 1)].mean(axis=0)
    rgb[below] = 0.3 * horizon_mean
    return rgb


def sun_radiance(sun_dir, turbidity: float = 2.5, exposure_scale: float = 0.025) -> np.ndarray:
    """Mean radiance of the solar disc after atmospheric extinction,
    consistent in scale with bake_sky (float64 on the host, then float32)."""
    to_sun = -np.asarray(sun_dir, np.float64)
    to_sun /= np.linalg.norm(to_sun)
    cos_zen = np.clip(to_sun[1], 0.02, 1.0)
    m = 1.0 / (cos_zen + 0.15 * (93.885 - np.degrees(np.arccos(cos_zen))) ** -1.253)
    beta = 0.04608 * turbidity - 0.04586
    # wavelength-ish extinction for RGB bands (550/610/465nm-ish)
    lam = np.array([0.61, 0.55, 0.465])
    tau_r = np.exp(-m * 0.008735 * lam**-4.08)
    tau_a = np.exp(-m * beta * lam**-1.3)
    # solar disc luminance ~1.6e6 kcd/m^2 outside the atmosphere; with the
    # disc solid angle (~6.8e-5 sr) this yields the ~10:1 sun:sky irradiance
    # ratio of a clear day
    base = 1.6e6 * exposure_scale
    return (base * tau_r * tau_a).astype(np.float32)
