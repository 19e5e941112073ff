"""The plain reference the benchmark holds the port's outputs against.

Plain PyTorch, imported by nothing of the program and importing nothing of
it.  Most functions are frozen copies of the port's plain versions at
commit 030ba3ae819e6d9e24ff92eb0e364588e49180de (the files are named on
each), with the same float32 operation order; the paint is written anew
as one scatter of the smallest qualifying source column per target, the
reference's first-writer-wins rule (core.hpp:1083-1129), and the sweep is
written per pixel (the pixels a check samples) instead of densely.

The sweep follows each of the program's three routes (``check.py`` says
which one a pass takes): the pixel rule, each pixel on its own grid with
its own sample positions (``ops/sweep.py``); the row rule, one shift a
(frame, candidate) for every column of a uniform level
(``ops/sweep_pallas.py`` ``_row_samples``); and the tile mode, a grid shared
by each 128-column tile (:func:`tile_grid`) with every pixel's own range
masking the candidates (``ops/sweep.py`` ``sweep_pile`` with
``pdmin_v_u``).  The last two are written from those rules, not copied.

Every function takes ``dtype``: float32 is the reference; the control
runs the same functions in bfloat16 (each input cast, each operation
rounded to it), the nearest precision below the configuration's.

The algorithm's constants (``PARAMS``, ``PYRAMID``) are the reference's
(rslf_depth_computation_core.hpp:15-37, rslf_fine_to_coarse.hpp:8), as
``config.py`` of the port copies them.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

F32 = torch.float32
SQRT3 = 1.73205080757

PARAMS = dict(
    kernel_h=0.2, edge_score_threshold=0.02, line_score_threshold=0.02,
    disp_score_threshold=0.01, raw_score_threshold=0.0,
    edge_confidence_filter_size=9,
    edge_confidence_opening_size=1, median_filter_size=5,
    median_filter_epsilon=0.1, propagation_epsilon=0.1, cut_shadows=True,
    shadow_level=0.05 * SQRT3)
PYRAMID = dict(min_spatial_dim=10, final_median_filter_size=3,
               accept_all_last_scale=True)

#: OpenCV getGaussianKernel(7, sigma<=0) fixed table (ops/pyramid.py)
GAUSSIAN7 = np.array(
    [0.03125, 0.109375, 0.21875, 0.28125, 0.21875, 0.109375, 0.03125],
    dtype=np.float32)


# -- numeric helpers (types.py) ---------------------------------------------

def f32(x: float) -> float:
    return float(np.float32(x))


def chan_scale(C: int) -> float:
    return 3.0 if C == 1 else 1.0


def channel_sumsq(x: torch.Tensor) -> torch.Tensor:
    acc = torch.square(x[..., 0])
    for c in range(1, x.shape[-1]):
        acc = acc + torch.square(x[..., c])
    return acc


def normsq(x: torch.Tensor) -> torch.Tensor:
    return chan_scale(x.shape[-1]) * channel_sumsq(x)


def norm(x: torch.Tensor) -> torch.Tensor:
    return torch.sqrt(normsq(x))


def round_half_away(x: torch.Tensor) -> torch.Tensor:
    return torch.sign(x) * torch.floor(torch.abs(x) + 0.5)


def div(a: torch.Tensor, b: float) -> torch.Tensor:
    """IEEE division by a number made a tensor (PyTorch turns ``x / c``
    into ``x * (1 / c)`` on the card)."""
    return a / torch.tensor(f32(b), dtype=a.dtype, device=a.device)


def _fl(x: torch.Tensor, dtype) -> torch.Tensor:
    return x if x.dtype == dtype else x.to(dtype)


# -- input and pyramid (normalize.py, pyramid.py, fine_to_coarse.py) --------

def normalize(level: torch.Tensor, dtype=F32) -> torch.Tensor:
    """uint8 scaled by 1/255, anything else by 1/max."""
    if level.dtype == torch.uint8:
        return div(level.to(dtype), 255.0)
    v = level.to(dtype)
    return v / torch.max(v)


def gaussian_blur_vu(frames: torch.Tensor) -> torch.Tensor:
    """Separable 7-tap Gaussian over the last two axes, BORDER_REFLECT."""
    w = 3

    def conv_axis(x, axis):
        n = x.shape[axis]
        idx = torch.as_tensor(np.pad(np.arange(n), (w, w), mode="symmetric"),
                              device=x.device)
        xp = torch.index_select(x, axis, idx)
        out = torch.zeros_like(x)
        for i in range(7):
            out = out + float(GAUSSIAN7[i]) * xp.narrow(axis, i, n)
        return out

    return conv_axis(conv_axis(frames, frames.dim() - 2), frames.dim() - 1)


def cv_resize_shape(dim: int) -> int:
    return int(np.rint(dim * 0.5))


def _axis_weights(n_in: int, n_out: int, scale: Optional[float]):
    if scale is None:
        scale = n_in / n_out
    src = (np.arange(n_out, dtype=np.float64) + 0.5) * scale - 0.5
    i0 = np.floor(src).astype(np.int64)
    t = (src - i0).astype(np.float32)
    t = np.where(i0 < 0, 0.0, t)
    t = np.where(i0 >= n_in - 1, 1.0, t).astype(np.float32)
    return (np.clip(i0, 0, n_in - 1), np.clip(i0 + 1, 0, n_in - 1), t)


def resize_bilinear_cv(img: torch.Tensor, out_shape: Tuple[int, int],
                       scales=None) -> torch.Tensor:
    """cv::resize INTER_LINEAR over the last two axes."""
    V, U = img.shape[-2:]
    sv, su = scales if scales is not None else (None, None)
    dev = img.device
    v0, v1, tv = _axis_weights(V, out_shape[0], sv)
    u0, u1, tu = _axis_weights(U, out_shape[1], su)
    tv = torch.as_tensor(tv, device=dev).to(img.dtype)
    tu = torch.as_tensor(tu, device=dev).to(img.dtype)
    a = torch.index_select(img, -2, torch.as_tensor(v0, device=dev))
    b = torch.index_select(img, -2, torch.as_tensor(v1, device=dev))
    x = a * (1.0 - tv)[:, None] + b * tv[:, None]
    a = torch.index_select(x, -1, torch.as_tensor(u0, device=dev))
    b = torch.index_select(x, -1, torch.as_tensor(u1, device=dev))
    return a * (1.0 - tu) + b * tu


def resize_nearest_cv(img: torch.Tensor, out_shape: Tuple[int, int]):
    V, U = img.shape[-2:]
    V2, U2 = out_shape
    vi = np.clip(np.floor(np.arange(V2) * (V / V2)).astype(np.int64), 0, V - 1)
    ui = np.clip(np.floor(np.arange(U2) * (U / U2)).astype(np.int64), 0, U - 1)
    out = torch.index_select(img, -2, torch.as_tensor(vi, device=img.device))
    return torch.index_select(out, -1, torch.as_tensor(ui, device=img.device))


def downsample(level_v_s_u_c: torch.Tensor) -> torch.Tensor:
    """One pyramid step: per-frame 7x7 Gaussian + 0.5x bilinear decimation,
    ``[V, S, U, C]`` -> ``[round(V/2), S, round(U/2), C]``."""
    V, S, U, C = level_v_s_u_c.shape
    frames = level_v_s_u_c.permute(1, 3, 0, 2)
    small = resize_bilinear_cv(gaussian_blur_vu(frames),
                               (cv_resize_shape(V), cv_resize_shape(U)),
                               scales=(2.0, 2.0))
    return small.permute(2, 0, 3, 1).contiguous()


def pyramid_inputs(vol: torch.Tensor, dtype=F32):
    """The levels of the fine-to-coarse pyramid as each level's computer
    takes them (uint8 volumes rounded half to even and clamped to [0, 255]
    at every level), fine to coarse, while V and U exceed the pyramid's
    minimum.  A generator: one level is held at a time."""
    is_u8 = vol.dtype == torch.uint8
    level = vol.to(dtype)
    lo = PYRAMID["min_spatial_dim"]
    while level.shape[0] > lo and level.shape[2] > lo:
        yield level.to(torch.uint8) if is_u8 else level
        level = downsample(level)
        if is_u8:
            level = torch.clamp(torch.round(level), 0, 255)


def level_count(V: int, U: int) -> int:
    n = 0
    lo = PYRAMID["min_spatial_dim"]
    while V > lo and U > lo:
        n += 1
        V, U = cv_resize_shape(V), cv_resize_shape(U)
    return n


# -- edge confidence (edge_confidence.py) -----------------------------------

def edge_confidence(e: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """C_e and its mask ``[V, S, U]`` of a normalized ``[V, S, U, C]``
    volume."""
    if PARAMS["edge_confidence_opening_size"] > 1:
        raise NotImplementedError("no opening in the reference")
    w = (PARAMS["edge_confidence_filter_size"] - 1) // 2
    U = e.shape[2]
    idx = torch.as_tensor(np.pad(np.arange(U), (w, w), mode="reflect"),
                          device=e.device)
    ep = torch.index_select(e, 2, idx)
    ce = torch.zeros(e.shape[:3], dtype=e.dtype, device=e.device)
    for o in range(-w, w + 1):
        if o == 0:
            continue
        ce = ce + channel_sumsq(e - ep[:, :, w + o: w + o + U])
    if PARAMS["cut_shadows"]:
        ce = torch.where(norm(e) < PARAMS["shadow_level"],
                         torch.zeros_like(ce), ce)
    return ce, ce > PARAMS["edge_score_threshold"]


# -- the sweep, per pixel (sweep.py, sweep_pallas.py,
#    sweep_pallas_perpixel.py) -----------------------------------------------

#: columns of a tile of the tile mode's grid, tiles aligned at u = 0 (the
#: JAX package's TPU lane width, its models/depth2d.py:405-414)
TILE = 128


def _sum_s(x: torch.Tensor, axis: int) -> torch.Tensor:
    """Sum over ``axis`` sequentially from index 0 (the kernels' order)."""
    acc = x.select(axis, 0)
    for s in range(1, x.shape[axis]):
        acc = acc + x.select(axis, s)
    return acc


def tile_grid(active: torch.Tensor, lo: torch.Tensor, hi: torch.Tensor,
              d_bounds: Tuple[float, float]):
    """The tile mode's grid bounds ``[V, U]`` of a pass over the
    ``active`` pixels ``[V, U]`` whose ranges are [``lo``, ``hi``]: each
    tile of :data:`TILE` columns, aligned at u = 0, takes the least ``lo``
    and the greatest ``hi`` of its active pixels, and a tile with none the
    level's bounds ``d_bounds``."""
    V, U = active.shape
    n = -(-U // TILE)
    pad = n * TILE - U
    has = F.pad(active, (0, pad)).reshape(V, n, TILE).any(dim=2)

    def reduce(x, lowest):
        fill = float("inf") if lowest else float("-inf")
        xt = F.pad(torch.where(active, x, torch.full_like(x, fill)),
                   (0, pad), value=fill).reshape(V, n, TILE)
        red = xt.amin(dim=2) if lowest else xt.amax(dim=2)
        red = torch.where(has, red, torch.full_like(
            red, f32(d_bounds[0] if lowest else d_bounds[1])))
        return red.repeat_interleave(TILE, dim=1)[:, :U]

    return reduce(lo, True), reduce(hi, False)


def sweep_pixels(epis: torch.Tensor, v: torch.Tensor, u: torch.Tensor,
                 lo: torch.Tensor, hi: torch.Tensor, D: int, s_hat: int,
                 slope: float, steps: int, interpolation: str = "linear",
                 dtype=F32, with_k: bool = False, chunk: int = 512,
                 rule: str = "pixel", plo: Optional[torch.Tensor] = None,
                 phi: Optional[torch.Tensor] = None):
    """The sweep of pixels (``v``, ``u``) ``[P]`` of a normalized volume
    ``[V, S, U, C]`` on their grids [``lo``, ``hi``] ``[P]``: every
    candidate's score, the mean score, every candidate's r_bar and (with
    ``with_k``) its last kernel values.  Returns a dict of ``cand`` [P,
    D], ``score`` [P, D], ``mean`` [P], ``rbar`` [P, D, C], ``k`` [P, D, S]
    (float32, whatever ``dtype`` computed them) and ``allowed`` [P, D]
    (None without ``plo``).

    ``rule`` places the samples: ``"pixel"``, I = u + ((s_hat - s) D[d])
    slope for each pixel (``ops/sweep.py`` ``_radiances``); ``"row"``, the
    shift ((s_hat - s) D[d]) slope shared by every column, f0 its floor
    and t = shift - f0: column u is valid where u >= -f0 and u <= U - 1 -
    (f0 + [t > 0]), and reads a where t = 0, else (1 - t) a + t b, with a
    and b at columns u + f0 and u + f0 + 1 (``ops/sweep_pallas.py``
    ``_row_samples``; linear interpolation only).

    ``plo``, ``phi`` ``[P]``: the tile mode's allowed ranges
    (``ops/sweep.py`` ``sweep_pile``'s ``pdmin_v_u``).  With step = (hi -
    lo) / (D - 1), a candidate outside [plo - step, phi + step] can
    neither win nor count: the mean is (sum * D / max(n_allowed, 1)) / D
    over the allowed ones."""
    V, S, U, C = epis.shape
    dev = epis.device
    flat = _fl(epis, dtype).reshape(-1)
    a_coef = f32(chan_scale(C) / (PARAMS["kernel_h"] ** 2))
    ds = float(s_hat) - torch.arange(S, dtype=dtype, device=dev)
    out = {k: [] for k in ("cand", "score", "mean", "rbar", "k", "allowed")}
    for i in range(0, v.numel(), chunk):
        vp, up = v[i:i + chunk], u[i:i + chunk]
        P = vp.numel()
        lo_p, hi_p = _fl(lo[i:i + chunk], dtype), _fl(hi[i:i + chunk], dtype)
        drange = (hi_p - lo_p)[:, None]
        den = torch.full_like(drange, float(D - 1))
        dd = torch.arange(D, dtype=dtype, device=dev)[None, :]
        delta = lo_p[:, None] + (drange * dd) / den                 # [P, D]
        shift = ds[None, None, :] * delta[:, :, None] * f32(slope)  # [P,D,S]
        idx = up.to(dtype)[:, None, None] + shift
        row = ((vp[:, None, None] * S + torch.arange(S, device=dev)
                [None, None, :]) * U)                              # [P, 1, S]
        cidx = torch.arange(C, device=dev)

        def gather(col):
            col = col.to(torch.int64).clamp(0, U - 1)
            return flat[((row + col) * C)[..., None] + cidx]       # [P,D,S,C]

        if rule == "row":
            f0 = torch.floor(shift)
            t = shift - f0
            i0 = f0.to(torch.int64)
            uc = up[:, None, None]
            valid = (uc >= -i0) & (uc <= (U - 1) - (i0 + (t > 0).long()))
            a, b = gather(uc + i0), gather(uc + i0 + 1)
            tt = t[..., None]
            val = torch.where(tt == 0, a, (1.0 - tt) * a + tt * b)
        elif interpolation == "nearest":
            ri = torch.sign(idx) * torch.floor(torch.abs(idx) + 0.5)
            valid = (ri >= 0) & (ri <= U - 1)
            val = gather(ri)
        else:
            fi, ci = torch.floor(idx), torch.ceil(idx)
            t = (idx - fi)[..., None]
            valid = (fi >= 0) & (ci <= U - 1)
            val = (1.0 - t) * gather(fi) + t * gather(ci)
        zero = torch.zeros((), dtype=dtype, device=dev)
        vc = valid[..., None]
        valraw = torch.where(vc, val, zero)
        valpos = torch.where(vc, torch.clamp_min(val, 0.0), zero)
        validf = valid.to(dtype)
        card = _sum_s(validf, 2)                                   # [P, D]
        rbar = flat[((vp * S + s_hat) * U + up)[:, None] * C + cidx]
        rbar = rbar[:, None, :].expand(P, D, C)
        k = None
        for _ in range(steps):
            diff = valraw - rbar[:, :, None, :]
            k = (torch.clamp_min(1.0 - a_coef * channel_sumsq(diff), 0.0)
                 * validf)
            sum_k = _sum_s(k, 2)[..., None]
            sum_rk = _sum_s(valpos * k[..., None], 2)
            rbar = torch.where(sum_k > 0, sum_rk / sum_k, zero)
        score = torch.where(card > 0, _sum_s(k, 2) / card, zero)   # [P, D]
        if plo is None:
            total = _sum_s(score, 1)
        else:
            step = drange / den
            allowed = ((delta >= _fl(plo[i:i + chunk], dtype)[:, None] - step)
                       & (delta <= _fl(phi[i:i + chunk], dtype)[:, None]
                          + step))
            n_allowed = _sum_s(allowed.to(dtype), 1)
            total = (_sum_s(torch.where(allowed, score, zero), 1) * float(D)
                     / torch.clamp_min(n_allowed, 1.0))
            out["allowed"].append(allowed)
        out["mean"].append(div(total, float(D)).float())
        out["cand"].append(delta.float())
        out["score"].append(score.float())
        out["rbar"].append(rbar.float())
        if with_k:
            out["k"].append(k.float())
    return {key: torch.cat(val) if val else None for key, val in out.items()}


# -- a pass's merge, median, line confidence and paint (depth2d.py,
#    median.py, propagation.py) ---------------------------------------------

def merge(pre: dict, s_hat: int, active: torch.Tensor, res: dict,
          dtype=F32) -> dict:
    """The s_hat planes after the sweep's results ``res`` (best_score,
    score_mean, best_depth, rbar at the pass's ``active`` pixels) are
    merged into the pass's starting state ``pre``."""
    zero = torch.zeros((), dtype=dtype, device=active.device)
    ok = _fl(res["best_score"], dtype) > PARAMS["raw_score_threshold"]
    good, bad = active & ok, active & ~ok
    ce_new = torch.where(bad, zero, _fl(pre["ce"][s_hat], dtype))
    conf = ce_new * torch.abs(_fl(res["best_score"], dtype)
                              - _fl(res["score_mean"], dtype))
    return dict(
        good=good,
        ce=ce_new,
        ce_mask=pre["ce_mask"][s_hat] & ~bad,
        best_depth=torch.where(good, _fl(res["best_depth"], dtype),
                               _fl(pre["best_depth"][s_hat], dtype)),
        disp_conf=torch.where(good, conf, _fl(pre["disp_conf"][s_hat],
                                               dtype)),
        rbar=torch.where(good[..., None], _fl(res["rbar"], dtype),
                         _fl(pre["rbar"][s_hat], dtype)))


def _sort_taps(taps):
    k = len(taps)
    taps = list(taps)
    for rnd in range(k):
        for i in range(rnd & 1, k - 1, 2):
            lo = torch.minimum(taps[i], taps[i + 1])
            hi = torch.maximum(taps[i], taps[i + 1])
            taps[i], taps[i + 1] = lo, hi
    return taps


def _pad_vu(x: torch.Tensor, w: int, w_end: int) -> torch.Tensor:
    if x.dim() == 2:
        return F.pad(x, (w, w_end, w, w_end))
    return F.pad(x, (0, 0, w, w_end, w, w_end))


def selective_median(src_v_u, frame_v_u_c, mask_v_u, dtype=F32):
    """The confidence- and colour-gated median of the (v, u) window
    (``median_filter_size``), 0 where the mask is unset."""
    size, eps = PARAMS["median_filter_size"], PARAMS["median_filter_epsilon"]
    src_v_u, frame_v_u_c = _fl(src_v_u, dtype), _fl(frame_v_u_c, dtype)
    V, U = src_v_u.shape
    w = (size - 1) // 2
    pads = (w, size - 1 - w)
    srcp = _pad_vu(src_v_u, *pads)
    maskp = _pad_vu(mask_v_u.to(dtype), *pads)
    framep = _pad_vu(frame_v_u_c, *pads)
    sortable = []
    n = torch.zeros((V, U), dtype=torch.int64, device=src_v_u.device)
    big = torch.tensor(float("inf"), dtype=dtype, device=src_v_u.device)
    for dy in range(size):
        for dx in range(size):
            mv = maskp[dy:dy + V, dx:dx + U]
            fv = framep[dy:dy + V, dx:dx + U, :]
            inc = (mv > 0) & (norm(frame_v_u_c - fv) < eps)
            sortable.append(torch.where(inc, srcp[dy:dy + V, dx:dx + U], big))
            n = n + inc.to(torch.int64)
    ordered = _sort_taps(sortable)
    pick = torch.clamp(n // 2, 0, size * size - 1)
    med = torch.gather(torch.stack(ordered, dim=-1), -1,
                       pick[..., None])[..., 0]
    return torch.where(mask_v_u, med, torch.zeros_like(med))


def _sum_halves(x: torch.Tensor) -> torch.Tensor:
    while x.shape[0] > 1:
        h = x.shape[0] // 2
        y = x[:h] + x[h:2 * h]
        x = torch.cat([y, x[2 * h:]]) if x.shape[0] % 2 else y
    return x[0]


def line_confidence(ce_s_v_u, depth_v_u, k_best_v_s_u, mask_v_u, s_hat,
                    dtype=F32):
    """C_l = sum_s C_e(I) K / sum_s K along each pixel's winning line, 0
    outside the mask (``depth2d.py`` ``_line_confidence``)."""
    ce_s_v_u, depth_v_u = _fl(ce_s_v_u, dtype), _fl(depth_v_u, dtype)
    S, V, U = ce_s_v_u.shape
    dev = ce_s_v_u.device
    zero = torch.zeros((), dtype=dtype, device=dev)
    ds = float(s_hat) - torch.arange(S, dtype=dtype, device=dev)
    idx = ds[:, None, None] * depth_v_u + torch.arange(U, dtype=dtype,
                                                       device=dev)
    fi = torch.floor(idx)
    valid = (fi >= 0) & (torch.ceil(idx) <= U - 1)
    t = idx - fi
    i0 = fi.to(torch.int64).clamp(0, U - 1)
    a = torch.gather(ce_s_v_u, 2, i0)
    b = torch.gather(ce_s_v_u, 2, (i0 + 1).clamp(max=U - 1))
    ce_i = torch.where(valid, (1.0 - t) * a + t * b, zero)
    k = _fl(k_best_v_s_u, dtype).permute(1, 0, 2)
    return torch.where(mask_v_u, _sum_halves(ce_i * k) / _sum_halves(k),
                       zero)


def paint(claim: torch.Tensor, frames: torch.Tensor, depth_v_u, rbar_v_u_c,
          source_mask: torch.Tensor, s_hat: int, slope: float,
          payloads: Sequence[Tuple[torch.Tensor, torch.Tensor]],
          dtype=F32, s_chunk: int = 8):
    """One pass of line painting on copies: every source paints its
    payloads at u + round_half_away((d slope)(s_hat - s)) in every frame s
    where the target is unclaimed and its colour is within
    ``propagation_epsilon`` of the source's r_bar; of the sources that
    qualify for a target the smallest u paints it.  Returns (claim,
    [targets]) new tensors."""
    S, V, U = claim.shape
    dev = claim.device
    C = frames.shape[-1]
    eps_sq = float(np.float32(PARAMS["propagation_epsilon"]) ** 2)
    claim = claim.clone()
    targets = [t.clone() for t, _ in payloads]
    vs, us = torch.nonzero(source_mask, as_tuple=True)
    if vs.numel() == 0:
        return claim, targets
    offs_src = _fl(depth_v_u, dtype)[vs, us] * f32(slope)
    rb_src = _fl(rbar_v_u_c, dtype)[vs, us]                       # [N, C]
    win = torch.full((S * V * U,), U, dtype=torch.int64, device=dev)
    frames_flat = frames.reshape(-1, C)
    for s0 in range(0, S, s_chunk):
        ss = torch.arange(s0, min(S, s0 + s_chunk), device=dev)
        ds = float(s_hat) - ss.to(dtype)
        offs = round_half_away(offs_src[None, :] * ds[:, None])    # [k, N]
        t = us[None, :] + offs.to(torch.int64)
        inb = (t >= 0) & (t < U)
        key = (ss[:, None] * V + vs[None, :]) * U + t.clamp(0, U - 1)
        col = normsq(_fl(frames_flat[key], dtype) - rb_src[None]) < eps_sq
        cond = inb & claim.reshape(-1)[key] & col
        win.scatter_reduce_(0, key[cond], us.expand_as(key)[cond], "amin")
    painted = torch.nonzero(win < U).reshape(-1)
    src_flat = (painted // U) % V * U + win[painted]
    claim.view(-1)[painted] = False
    for tgt, (_, src) in zip(targets, payloads):
        tgt.view(-1)[painted] = src.reshape(-1)[src_flat].to(tgt.dtype)
    return claim, targets


# -- the pyramid's bounds, validity and fusion (pyramid.py,
#    depth2d.py, median.py) --------------------------------------------------

def validity(state: dict, score_version: str, accept_all: bool):
    """A level's valid-depth mask ``[S, V, U]`` from its final state."""
    if accept_all:
        return torch.ones_like(state["ce"], dtype=torch.bool)
    if score_version == "edge":
        return state["ce"] > PARAMS["edge_score_threshold"]
    if score_version == "disp":
        return state["disp_conf"] > PARAMS["disp_score_threshold"]
    return state["line_conf"] > PARAMS["line_score_threshold"]


def bounds_from_parent(depth_up, mask_up, dmin_down, dmax_down):
    """Per-pixel bounds of the next (coarser) level from the nearest
    masked parents left and right on two parent rows
    (rslf_fine_to_coarse.hpp:202-294)."""
    S, Vu, Uu = depth_up.shape
    _, Vd, Ud = dmin_down.shape
    dev = depth_up.device
    u_idx = torch.arange(Uu, device=dev)
    li = torch.where(mask_up & (u_idx >= 1), u_idx, -1)
    lcum = torch.cummax(li, dim=2).values
    left = torch.cat([torch.full((S, Vu, 1), -1, device=dev,
                                 dtype=lcum.dtype), lcum[:, :, :-1]], dim=2)
    ri = torch.where(mask_up, u_idx, Uu)
    rcum = torch.flip(torch.cummin(torch.flip(ri, [2]), dim=2).values, [2])
    right = torch.cat([rcum[:, :, 1:], torch.full((S, Vu, 1), Uu, device=dev,
                                                  dtype=rcum.dtype)], dim=2)
    dl = torch.gather(depth_up, 2, torch.clamp(left, 0, Uu - 1))
    dr = torch.gather(depth_up, 2, torch.clamp(right, 0, Uu - 1))
    pair_ok = (left >= 1) & (right < Uu)
    pmin, pmax = torch.minimum(dl, dr), torch.maximum(dl, dr)
    v_up = np.minimum(2 * np.arange(Vd), Vu - 1)
    u_up = torch.as_tensor(np.minimum(2 * np.arange(Ud), Uu - 1), device=dev)
    v_up2 = v_up + 1
    row2 = torch.as_tensor(v_up2 < Vu, device=dev)
    v_up = torch.as_tensor(v_up, device=dev)
    v_up2c = torch.as_tensor(np.minimum(v_up2, Vu - 1), device=dev)

    def at(arr, rows):
        return torch.index_select(torch.index_select(arr, 1, rows), 2, u_up)

    ok1 = at(pair_ok, v_up)
    ok2 = at(pair_ok, v_up2c) & row2[None, :, None]
    inf = torch.tensor(float("inf"), dtype=depth_up.dtype, device=dev)
    new_min = torch.minimum(torch.where(ok1, at(pmin, v_up), inf),
                            torch.where(ok2, at(pmin, v_up2c), inf))
    new_max = torch.maximum(torch.where(ok1, at(pmax, v_up), -inf),
                            torch.where(ok2, at(pmax, v_up2c), -inf))
    any_pair = ok1 | ok2
    return (torch.where(any_pair, new_min, dmin_down.to(depth_up.dtype)),
            torch.where(any_pair, new_max, dmax_down.to(depth_up.dtype)))


def median_blur(img: torch.Tensor, size: int) -> torch.Tensor:
    """cv::medianBlur with replicated borders over the last two axes."""
    V, U = img.shape[-2:]
    w = (size - 1) // 2
    lead = img.shape[:-2]
    p = F.pad(img.reshape(-1, 1, V, U), (w, w, w, w), mode="replicate")
    p = p.reshape(*lead, V + 2 * w, U + 2 * w)
    taps = [p[..., dy:dy + V, dx:dx + U]
            for dy in range(size) for dx in range(size)]
    return _sort_taps(taps)[(size * size) // 2]


def fuse(disp_pyr: List[torch.Tensor], validity_pyr: List[torch.Tensor],
         dtype=F32):
    """Coarse-to-fine fusion of the levels' maps: upsample (bilinear map,
    nearest mask), fill each finer level's invalid pixels, OR the masks,
    then a median blur.  Returns (fused [S, V, U], validity)."""
    P = len(disp_pyr)
    map_down = _fl(disp_pyr[P - 1], dtype)
    mask_down = validity_pyr[P - 1]
    for p in range(P - 1, 0, -1):
        shape = tuple(disp_pyr[p - 1].shape[-2:])
        map_up = resize_bilinear_cv(map_down, shape)
        mask_up = resize_nearest_cv(mask_down, shape)
        fine = validity_pyr[p - 1]
        map_down = torch.where(fine, _fl(disp_pyr[p - 1], dtype), map_up)
        mask_down = fine | mask_up
    return (median_blur(map_down, PYRAMID["final_median_filter_size"]),
            mask_down)
