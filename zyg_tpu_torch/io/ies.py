"""IES (IESNA LM-63) photometric profile reader (counterpart of
zyg_tpu/io/ies.py, the same numpy in the same operation order, so the
bins are equal array for array).

A profile is reduced to a 1-D normalized intensity curve over the polar
angle from the light's emission axis (horizontal angles averaged: the
common axially symmetric case), resampled to PROFILE_BINS bins so it packs
into the material table (`Materials.ies`); render/materials.py::eval_ies
reads it per lane.
"""

from __future__ import annotations

import numpy as np

PROFILE_BINS = 32  # resampled intensity bins over theta in [0, pi]


def parse_ies(text: str) -> tuple[np.ndarray, np.ndarray] | None:
    """LM-63 text -> (vertical angles in degrees [V], intensity [V])
    averaged over the horizontal angles, or None for malformed input or a
    photometric type other than C."""
    lines = text.splitlines()
    start = None
    tilt_include = False
    for i, ln in enumerate(lines):
        if ln.upper().startswith("TILT="):
            start = i + 1
            tilt_include = "INCLUDE" in ln.upper()
            break
    if start is None:
        return None
    tokens: list[float] = []
    for ln in lines[start:]:
        for tok in ln.replace(",", " ").split():
            try:
                tokens.append(float(tok))
            except ValueError:
                return None
    if tilt_include:
        # the tilt block is counted in tokens (values may wrap across
        # lines): lamp-to-luminaire geometry, n pairs, n angles, n factors
        if len(tokens) < 2:
            return None
        n_pairs = int(tokens[1])
        if n_pairs < 0 or len(tokens) < 2 + 2 * n_pairs:
            return None
        tokens = tokens[2 + 2 * n_pairs:]
    if len(tokens) < 13:
        return None
    # header: lamps, lumens a lamp, multiplier, vertical and horizontal
    # angle counts, photometric type, units, width, length, height,
    # ballast, future use, watts
    n_vert = int(tokens[3])
    n_horiz = int(tokens[4])
    if int(tokens[5]) != 1:
        return None  # types A and B parametrize their angles differently
    mult = tokens[2]
    base = 13
    if n_vert <= 0 or n_horiz <= 0:
        return None
    if len(tokens) < base + n_vert + n_horiz + n_vert * n_horiz:
        return None
    v_angles = np.asarray(tokens[base: base + n_vert], np.float64)
    if (v_angles < 0.0).any() or (np.diff(v_angles) < 0.0).any():
        return None
    base += n_vert + n_horiz
    candela = np.asarray(tokens[base: base + n_vert * n_horiz], np.float64).reshape(n_horiz, n_vert)
    return v_angles, mult * candela.mean(axis=0)


def ies_profile_bins(text: str, bins: int = PROFILE_BINS) -> np.ndarray | None:
    """LM-63 text -> float32[bins] intensity over theta in [0, pi] from the
    emission axis, normalized so its cosine-weighted hemisphere mean is 1
    (the profile redistributes the emission without changing its power);
    None where parse_ies refuses the text or the mean is not positive."""
    parsed = parse_ies(text)
    if parsed is None:
        return None
    v_angles, intensity = parsed
    theta = np.linspace(0.0, 180.0, bins)
    prof = np.interp(theta, v_angles, intensity, left=intensity[0], right=intensity[-1])
    th = np.deg2rad(theta)
    w = np.abs(np.cos(th)) * np.sin(th)
    denom = float((prof * w).sum() / max(w.sum(), 1e-12))
    if denom <= 0.0:
        return None
    return (prof / denom).astype(np.float32)
