"""Visualization: colormaps, byte scaling, rendered maps.

Counterpart of ``remotesensingproject_tpu/utils/plot.py`` (reference:
rslf_plot, include/rslf_plot.hpp + src/rslf_plot.cpp) minus the
interactive windows: render to numpy uint8 images; saving is in utils.io.
Rendering stays on the host in numpy, as in the JAX package (it is not on
the hot path): tensors come in through ``.detach().cpu().numpy()``, and
the same arrays give the same bytes as the JAX package's renderers.
"""

from __future__ import annotations

import numpy as np
import torch


def _np(x) -> np.ndarray:
    """A host numpy array of a tensor (on any device) or an array."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


# ---------------------------------------------------------------------------
# colormaps
# ---------------------------------------------------------------------------

def _jet_lut() -> np.ndarray:
    """The jet colormap as a 256-entry RGB table (matches OpenCV's
    COLORMAP_JET rendering; verified against cv2 in tests)."""
    from ._jet_lut import JET_LUT
    return np.asarray(JET_LUT, np.uint8)


_LUTS = {"jet": _jet_lut()}


def apply_colormap(img_u8: np.ndarray, colormap: str = "jet") -> np.ndarray:
    """Map a uint8 image to RGB via a 256-entry LUT (cv::applyColorMap)."""
    lut = _LUTS[colormap]
    return lut[_np(img_u8)]


# ---------------------------------------------------------------------------
# byte scaling
# ---------------------------------------------------------------------------

def saturate_cast_u8(x: np.ndarray) -> np.ndarray:
    """float -> uint8 with cvRound (half-to-even) + clamping."""
    return np.clip(np.rint(x), 0, 255).astype(np.uint8)


def copy_and_scale_uchar(img) -> np.ndarray:
    """Min-max scale to uint8 (rslf::copy_and_scale_uchar,
    src/rslf_plot.cpp:40-63).  uint8 input is returned unchanged."""
    img = _np(img)
    if img.dtype == np.uint8:
        return img.copy()
    mn = float(img.min())
    mx = float(img.max())
    scale = 255.0 / (mx - mn) if mx > mn else 0.0
    return saturate_cast_u8((img - mn) * scale)


class ImageConverterUint8:
    """Quantile-saturating byte scaler (rslf::ImageConverter_uchar,
    src/rslf_plot.cpp:66-107)."""

    def __init__(self):
        self.min = None
        self.max = None

    def fit(self, img, saturate: bool = True):
        img = _np(img)
        flat = img.reshape(img.shape[0] * img.shape[1], -1)
        if saturate:
            # 2% / 98% quantiles of channel 0, by sorted index
            # (rslf_plot.cpp:73-81)
            col = np.sort(flat[:, 0])
            n = flat.shape[0]
            self.min = float(col[int(np.floor(0.02 * n))])
            self.max = float(col[int(np.floor(0.98 * n))])
        else:
            true_min = float(img.min())
            true_max = float(img.max())
            mean = float(img.mean())
            std = float(img.std())
            self.min = true_min
            self.max = min(mean + 12 * std, true_max)
        return self

    def copy_and_scale(self, src) -> np.ndarray:
        assert self.min is not None, "fit before use"
        alpha = 255.0 / (self.max - self.min) if self.max > self.min else 0.0
        return saturate_cast_u8(_np(src) * alpha - alpha * self.min)


# ---------------------------------------------------------------------------
# rendered products
# ---------------------------------------------------------------------------

def disparity_map_image(depth_v_u, mask_v_u, colormap: str = "jet"):
    """Colormapped disparity map, black where mask unset
    (Depth1DComputer_pile::get_disparity_map,
    rslf_depth_computation.hpp:620-641)."""
    scaled = copy_and_scale_uchar(_np(depth_v_u))
    rgb = apply_colormap(scaled, colormap)
    rgb[~_np(mask_v_u)] = 0
    return rgb


def coloured_epi_from_pile(pile, v: int, colormap: str = "jet"):
    """Occlusion-aware EPI line painting
    (Depth1DComputer_pile::get_coloured_epi,
    rslf_depth_computation.hpp:567-618)."""
    best_depth = _np(pile.result.best_depth)[v]
    mask = _np(pile.result.edge_mask)[v]
    S, U = pile.epis.shape[1], pile.epis.shape[2]
    return _paint_epi_lines(best_depth, mask, S, U, pile.s_hat, colormap)


def coloured_epi_lines(epi, result, s_hat: int, params,
                       colormap: str = "jet"):
    """Depth1DComputer::get_coloured_epi
    (rslf_depth_computation.hpp:373-416)."""
    S, U = epi.shape[:2]
    best_depth = _np(result.best_depth)
    mask = _np(result.edge_mask)
    # note: the single-EPI variant tests requested_index > 0 (not > -1)
    return _paint_epi_lines(best_depth, mask, S, U, s_hat, colormap,
                            min_index=1)


def _paint_epi_lines(best_depth_u, mask_u, S, U, s_hat, colormap,
                     min_index: int = 0):
    scaled = copy_and_scale_uchar(best_depth_u)
    colours = apply_colormap(scaled, colormap)  # [U, 3]
    out = np.zeros((S, U, 3), np.uint8)
    occlusion = np.full((S, U), -np.inf, np.float32)
    for u in range(U):
        if not mask_u[u]:
            continue
        d = best_depth_u[u]
        for s in range(S):
            # std::round = half away from zero
            off = d * (s_hat - s)
            t = u + int(np.sign(off) * np.floor(abs(off) + 0.5))
            if min_index <= t < U and occlusion[s, t] < d:
                out[s, t] = colours[u]
                occlusion[s, t] = d
    return out


def coloured_depth_maps(fused_s_v_u, validity_s_v_u, epis_v_s_u_c, params,
                        colormap: str = "jet", saturate: bool = True):
    """FineToCoarse::get_coloured_depth_maps
    (rslf_fine_to_coarse.hpp:324-377): one converter fitted on the center
    frame, colormap, zero where invalid, shadow cut on the frame norm."""
    fused = _np(fused_s_v_u)
    validity = _np(validity_s_v_u)
    epis = _np(epis_v_s_u_c)
    S = fused.shape[0]
    conv = ImageConverterUint8().fit(fused[int(round(S / 2.0))], saturate)
    maps = []
    C = epis.shape[-1]
    chan = 3.0 if C == 1 else 1.0
    for s in range(S):
        rgb = apply_colormap(conv.copy_and_scale(fused[s]), colormap)
        rgb[~validity[s]] = 0
        if params.cut_shadows:
            frame = epis[:, s]  # [V, U, C]
            nrm = np.sqrt(chan * np.sum(frame.astype(np.float64) ** 2, -1))
            rgb[nrm < params.shadow_level] = 0
        maps.append(rgb)
    return np.stack(maps)


def coloured_epi_2d(depths_s_v_u, valid_s_v_u, v: int,
                    colormap: str = "jet"):
    """Depth2DComputer::get_coloured_epi
    (rslf_depth_computation.hpp:807-860): the (s, u) depth slice at row v,
    colormapped, painted only where the validity criterion holds."""
    depths = _np(depths_s_v_u)[:, v, :]       # [S, U]
    valid = _np(valid_s_v_u)[:, v, :]
    rgb = apply_colormap(copy_and_scale_uchar(depths), colormap)
    rgb[~valid] = 0
    return rgb


def depth_pyramid_images(depth_slices, valid_slices, saturate: bool = True,
                         colormap: str = "jet"):
    """Shared renderer for FineToCoarse::get_coloured_epi_pyr /
    get_coloured_depth_pyr (rslf_fine_to_coarse.hpp:431-518): one
    converter fitted on the finest level, per-level colormapped slices
    with invalid pixels black."""
    conv = ImageConverterUint8()
    out = []
    for p, (d, m) in enumerate(zip(depth_slices, valid_slices)):
        d = _np(d)
        m = _np(m)
        if p == 0:
            conv.fit(d, saturate)
        rgb = apply_colormap(conv.copy_and_scale(d), colormap)
        rgb[~m] = 0
        out.append(rgb)
    return out


def side_by_side(img_a: np.ndarray, img_b: np.ndarray) -> np.ndarray:
    """Concatenate frame + map like get_coloured_depth_maps_and_imgs
    (rslf_fine_to_coarse.hpp:380-429): rows when wide, cols when tall."""
    if img_a.ndim == 2:
        img_a = np.stack([img_a] * 3, -1)
    if img_a.shape[1] > img_a.shape[0]:
        return np.concatenate([img_a, img_b], axis=0)
    return np.concatenate([img_a, img_b], axis=1)


def draw_red_lines(img, fill_row_red: int = -1, max_height: int = -1,
                   fill_col_red: int = -1, max_width: int = -1):
    """Red-line overlay + crop for EPI figures (src/rslf_plot.cpp:110-199)."""
    res = copy_and_scale_uchar(_np(img))
    if fill_row_red < 0 and fill_col_red < 0:
        return res
    if res.ndim == 2:
        res = np.stack([res] * 3, axis=-1)
    red = np.array([255, 0, 0], np.uint8)
    if fill_row_red > -1:
        res[fill_row_red, :] = red
    if fill_col_red > -1:
        res[:, fill_col_red] = red
    if fill_row_red > -1 and max_height > 0:
        first = 0 if fill_row_red - max_height < 0 else \
            fill_row_red - max_height // 2
        last = first + max_height if first + max_height < res.shape[0] \
            else res.shape[0] - 1
        res = res[first:last]
    if fill_col_red > -1 and max_width > 0:
        first = 0 if fill_col_red - max_width < 0 else \
            fill_col_red - max_width // 2
        last = first + max_width if first + max_width < res.shape[1] \
            else res.shape[1] - 1
        res = res[:, first:last]
    return res
