"""Behavioral NumPy/cv2 transcriptions of the reference algorithms — golden generators.

The reference (bullbin/pySP) cannot run in this environment: its native deps (rawpy,
exifread, tifftools, colour-science) are absent and its two Cython kernels only build
with MSVC. Golden outputs therefore come from faithful NumPy
re-implementations of the reference behavior, executed with the same cv2 calls the
reference makes. These exist ONLY for test parity and CPU baseline timing.

Transcribed behaviors (file:line refs into /root/reference):
- draft demosaic       fast_resize.py:7-44
- EAG demosaic         edge_assisted_gaussian.py:10-201
- AHD demosaic         ahd.py:14-170 + ahd_homogeneity_cython.pyx:22-69 (vectorized)
- cam->lin-sRGB        colorize/transform.py:21-87
"""
from __future__ import annotations

import cv2
import numpy as np


# --- color ---------------------------------------------------------------------------
def ref_cam_to_lin_srgb(rgb, cam_mat, cam_white_xyz, clip_highlights=True):
    from pysp_tpu.colorimetry.spaces import LinRgbColorspace

    if clip_highlights:
        rgb = np.clip(rgb, 0, 1)
    dest = LinRgbColorspace.REC709.mat_to_xyz(tuple(np.asarray(cam_white_xyz)))
    color_mat = np.asarray(cam_mat, np.float64) @ dest
    color_mat = color_mat / color_mat.sum(axis=1)[:, None]
    color_mat = np.linalg.inv(color_mat)
    return np.dot(rgb, color_mat.T).astype(np.float32)


def ref_lin_srgb_to_srgb(rgb):
    rgb = np.clip(rgb, 0, 1)
    return np.where(rgb <= 0.0031308, rgb * 12.92, 1.055 * rgb ** (1 / 2.4) - 0.055)


# --- plumbing ------------------------------------------------------------------------
def split(bayer):
    evens = bayer[0::2, :].astype(np.float32)
    odds = bayer[1::2, :].astype(np.float32)
    return evens[:, 0::2], evens[:, 1::2], odds[:, 1::2], odds[:, 0::2]


def merge(r, g1, b, g2):
    out = np.zeros((r.shape[0] * 2, r.shape[1] * 2), dtype=np.float32)
    out[0::2, 0::2] = r
    out[0::2, 1::2] = g1
    out[1::2, 1::2] = b
    out[1::2, 0::2] = g2
    return out


# --- draft (fast_resize.py) ----------------------------------------------------------
def ref_demosaic_draft(bayer, wb):
    r, g1, b, g2 = split(bayer)
    rgb = np.zeros((r.shape[0], r.shape[1], 3), np.float32)
    rgb[:, :, 1] = ((g1 + g2) / 2) * wb[1]

    r = cv2.copyMakeBorder(r, 0, 1, 0, 1, cv2.BORDER_REFLECT)
    b = cv2.copyMakeBorder(b, 1, 0, 1, 0, cv2.BORDER_REFLECT)
    r = 0.75 * r[:-1, :-1] + 0.25 * r[1:, 1:]
    b = 0.75 * b[1:, 1:] + 0.25 * b[:-1, :-1]
    rgb[:, :, 0] = r * wb[0]
    rgb[:, :, 2] = b * wb[2]
    return cv2.resize(rgb, (bayer.shape[1], bayer.shape[0]))


# --- EAG (edge_assisted_gaussian.py) -------------------------------------------------
_BINOM5 = np.array(
    [
        [1, 4, 6, 4, 1],
        [4, 16, 24, 16, 4],
        [6, 24, 36, 24, 6],
        [4, 16, 24, 16, 4],
        [1, 4, 6, 4, 1],
    ],
    np.float64,
)


def _phase_kernels(base_position):
    # gaussian.py:19-54; positions: 0=TL 1=TR 2=BL 3=BR
    is_base_left = base_position in (0, 2)
    is_base_bottom = base_position in (2, 3)
    out = []
    for idx in range(4):
        is_left = idx in (0, 2)
        is_bottom = idx in (2, 3)
        k = _BINOM5[0::2] if is_base_bottom == is_bottom else _BINOM5[1::2]
        k = k[:, 0::2] if is_base_left == is_left else k[:, 1::2]
        if is_left != is_base_left:
            z = np.zeros((k.shape[0], 1))
            k = np.hstack([k, z]) if is_left else np.hstack([z, k])
        if is_bottom != is_base_bottom:
            z = np.zeros((1, k.shape[1]))
            k = np.vstack([z, k]) if is_bottom else np.vstack([k, z])
        out.append(k / k.sum())
    return out


def _delta_mix(top, bottom, left, right):
    dy = np.abs(top - bottom)
    dx = np.abs(left - right)
    sd = dy + dx
    avg_x = (left + right) / 2
    avg_y = (top + bottom) / 2
    sy = np.divide(dy, sd, out=np.ones_like(sd) * 0.5, where=sd != 0)
    sx = 1 - sy
    return avg_y * sx + avg_x * sy


def ref_resample_g_full(g1, g2, weighted=True):
    g1p = cv2.copyMakeBorder(g1, 1, 1, 1, 1, cv2.BORDER_REFLECT)
    g2p = cv2.copyMakeBorder(g2, 1, 1, 1, 1, cv2.BORDER_REFLECT)
    b_t = g1p[1:-1, 1:-1]
    b_b = g1p[2:, 1:-1]
    b_l = g2p[1:-1, 1:-1]
    b_r = g2p[1:-1, 2:]
    r_t = g2p[:-2, 1:-1]
    r_b = g2p[1:-1, 1:-1]
    r_l = g1p[1:-1, :-2]
    r_r = g1p[1:-1, 1:-1]
    if weighted:
        r = _delta_mix(r_t, r_b, r_l, r_r)
        b = _delta_mix(b_t, b_b, b_l, b_r)
    else:
        r = (r_t + r_b + r_l + r_r) / 4
        b = (b_t + b_b + b_l + b_r) / 4
    return merge(r, g1, b, g2)


def ref_resample_channel(subpixel, g_at_subpixel, g_hf_pass, position):
    k_tl, k_tr, k_bl, k_br = _phase_kernels(position)

    def up(x):
        return merge(
            cv2.filter2D(x, -1, k_tl),
            cv2.filter2D(x, -1, k_tr),
            cv2.filter2D(x, -1, k_br),
            cv2.filter2D(x, -1, k_bl),
        )

    g_up = up(g_at_subpixel) + g_hf_pass
    return up(subpixel - g_at_subpixel) + g_up


def ref_resample_rb(r, b, g_up):
    g_hf = g_up - cv2.GaussianBlur(g_up, (3, 3), 1.0)
    g_r, _, g_b, _ = split(g_up)
    return (
        ref_resample_channel(r, g_r, g_hf, 0),
        ref_resample_channel(b, g_b, g_hf, 3),
    )


def ref_demosaic_eag(bayer, wb):
    r, g1, b, g2 = split(bayer)
    g_up = ref_resample_g_full(g1, g2) * wb[1]
    r_up, b_up = ref_resample_rb(r * wb[0], b * wb[2], g_up)
    return np.dstack([r_up, g_up, b_up])


# --- AHD (ahd.py + .pyx) -------------------------------------------------------------
def ref_build_map(lab, k_pad, domain_k, is_vertical):
    """Vectorized transcription of ahd_homogeneity_cython.pyx:22-69.

    ``lab`` is the already-padded LAB image; output is (H-2*k_pad, W-2*k_pad).
    """
    ph, pw = lab.shape[:2]
    h, w = ph - 2 * k_pad, pw - 2 * k_pad

    def win(dy, dx):
        return lab[k_pad + dy : k_pad + dy + h, k_pad + dx : k_pad + dx + w]

    center = win(0, 0)
    if is_vertical:
        n1, n2 = win(-1, 0), win(1, 0)
    else:
        n1, n2 = win(0, -1), win(0, 1)

    eps_l = np.maximum(np.abs(center[..., 0] - n1[..., 0]), np.abs(center[..., 0] - n2[..., 0]))
    eps_c2 = np.maximum(
        (center[..., 1] - n1[..., 1]) ** 2 + (center[..., 2] - n1[..., 2]) ** 2,
        (center[..., 1] - n2[..., 1]) ** 2 + (center[..., 2] - n2[..., 2]) ** 2,
    )

    count = np.zeros((h, w), np.float32)
    for dy in range(-k_pad, k_pad + 1):
        for dx in range(-k_pad, k_pad + 1):
            ww = win(dy, dx)
            ok = (ww[..., 0] - center[..., 0]) <= eps_l
            ok &= ((ww[..., 1] - center[..., 1]) ** 2 + (ww[..., 2] - center[..., 2]) ** 2) <= eps_c2
            count += ok
    return count


def ref_demosaic_ahd(
    bayer, wb, cam_mat, cam_white, is_hdr=False, postprocess_stages=1, lab_fn=None
):
    """lab_fn: RGB->LAB converter; default cv2.cvtColor. Pass the framework's exact
    closed-form rgb_to_lab to isolate the rest of the pipeline from cv2's internal
    gamma-LUT approximation error (~4e-3 in Y), which flips H/V picks at ties."""
    if lab_fn is None:
        lab_fn = lambda im: cv2.cvtColor(im, cv2.COLOR_RGB2LAB)
    r, g1, b, g2 = split(bayer)

    r = cv2.copyMakeBorder(r, 1, 1, 1, 1, cv2.BORDER_REFLECT) * wb[0]
    g1 = cv2.copyMakeBorder(g1, 1, 1, 1, 1, cv2.BORDER_REFLECT) * wb[1]
    b = cv2.copyMakeBorder(b, 1, 1, 1, 1, cv2.BORDER_REFLECT) * wb[2]
    g2 = cv2.copyMakeBorder(g2, 1, 1, 1, 1, cv2.BORDER_REFLECT) * wb[1]

    h_opt = np.array([-0.2569, 0.4339, 0.5138, 0.4339, -0.2569], np.float32)
    h_fast = np.array([-0.25, 0.5, 0.5, 0.5, -0.25], np.float32)
    h = h_opt * 0.125 + h_fast * 0.875
    h = h / h.sum()

    gh_r = (r[1:-1, :-2] * h[0] + g1[1:-1, :-2] * h[1] + r[1:-1, 1:-1] * h[2]
            + g1[1:-1, 1:-1] * h[3] + r[1:-1, 2:] * h[4])
    gv_r = (r[:-2, 1:-1] * h[0] + g2[:-2, 1:-1] * h[1] + r[1:-1, 1:-1] * h[2]
            + g2[1:-1, 1:-1] * h[3] + r[2:, 1:-1] * h[4])
    gh_b = (b[1:-1, :-2] * h[0] + g2[1:-1, 1:-1] * h[1] + b[1:-1, 1:-1] * h[2]
            + g2[1:-1, 2:] * h[3] + b[1:-1, 2:] * h[4])
    gv_b = (b[:-2, 1:-1] * h[0] + g1[1:-1, 1:-1] * h[1] + b[1:-1, 1:-1] * h[2]
            + g1[2:, 1:-1] * h[3] + b[2:, 1:-1] * h[4])

    g_h = merge(gh_r, g1[1:-1, 1:-1], gh_b, g2[1:-1, 1:-1])
    g_v = merge(gv_r, g1[1:-1, 1:-1], gv_b, g2[1:-1, 1:-1])

    delta_gh_hf = g_h - cv2.GaussianBlur(g_h, (3, 3), 1.0)
    delta_gv_hf = g_v - cv2.GaussianBlur(g_v, (3, 3), 1.0)

    r_h = ref_resample_channel(r[1:-1, 1:-1], gh_r, delta_gh_hf, 0)
    r_v = ref_resample_channel(r[1:-1, 1:-1], gv_r, delta_gv_hf, 0)
    b_h = ref_resample_channel(b[1:-1, 1:-1], gh_b, delta_gh_hf, 3)
    b_v = ref_resample_channel(b[1:-1, 1:-1], gv_b, delta_gv_hf, 3)

    def homo(rr, gg, bb, is_vertical):
        im_rgb = ref_cam_to_lin_srgb(
            np.dstack([rr * wb[0], gg * wb[1], bb * wb[2]]),
            cam_mat, cam_white, clip_highlights=False,
        )
        if is_hdr:
            luma = 0.2126 * im_rgb[..., 0] + 0.7152 * im_rgb[..., 1] + 0.0722 * im_rgb[..., 2]
            im_rgb = im_rgb / (1 + im_rgb)
            lab = np.array(lab_fn(im_rgb))
            lab[..., 0] = luma
        else:
            lab = np.array(lab_fn(im_rgb))
        lab = cv2.copyMakeBorder(lab, 1, 1, 1, 1, cv2.BORDER_REFLECT)
        return ref_build_map(lab, 1, 3, is_vertical)

    map_h = cv2.blur(homo(r_h, g_h, b_h, False), (3, 3))
    map_v = cv2.blur(homo(r_v, g_v, b_v, True), (3, 3))

    comb = (map_h < map_v).astype(np.float32)[..., None]
    out = np.dstack([r_h, g_h, b_h]) * comb + np.dstack([r_v, g_v, b_v]) * (1 - comb)

    for _ in range(max(postprocess_stages, 0)):
        rr = out[:, :, 0]
        gg = out[:, :, 1]
        bb = out[:, :, 2]
        rr = cv2.medianBlur(rr - gg, 5) + gg
        bb = cv2.medianBlur(bb - gg, 5) + gg
        gg = (cv2.medianBlur(gg - rr, 5) + cv2.medianBlur(gg - bb, 5) + rr + bb) / 2
        out = np.dstack([rr, gg, bb])

    return out
