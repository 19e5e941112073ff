"""The benchmark's scenes: bench.py's layered-texture light fields.

Frozen copy of ``_layered_texture``, ``synthetic_sequence`` and
``synthetic_sequence_rgb`` from ``remotesensingproject_tpu_torch/bench.py``
at commit 030ba3ae819e6d9e24ff92eb0e364588e49180de (themselves bench.py's
numpy draws, bit for bit).  The benchmark keeps its own copy so that the
inputs it times cannot change with the program; a test holds the copy
against the program's generators.

``synthetic_sequence_bands`` is the four-band scene of ``chip_smoke.py``
(its ``synthetic_sequence`` with ``gains=BAND_GAINS``, phase 5): the gray
scene's draws, each layer's radiance scaled by one gain a band, with a
frozen copy of its :data:`BAND_GAINS`.  The gains are made up for that
scene, not taken from a published sensor.

A configuration file names its generator under ``"scene"`` (see
:data:`GENERATORS`); the seed of a run is the generator's seed.
"""

from __future__ import annotations

import numpy as np
import torch

#: per-layer gains of the four bands (blue, green, red, near-infrared),
#: ``chip_smoke.py``'s ``BAND_GAINS``
BAND_GAINS = np.array([[1.00, 0.85, 0.70, 0.95], [0.60, 0.75, 0.90, 1.00],
                       [0.90, 1.00, 0.65, 0.55], [0.70, 0.60, 0.95, 0.80],
                       [0.85, 0.95, 0.80, 0.60], [0.55, 0.70, 0.60, 0.90]],
                      np.float32)


def _layered_texture(rng, S, U, dmin, dmax):
    """Six layers of disparities in [dmin, dmax], strip intervals and
    sinusoid textures (wavelengths 6-60 px), in bench.py's draw order.
    Returns (disparities [6], owner [S, U]: the nearest covering layer,
    val0 [S, U] float32: its radiance)."""
    s_hat = S // 2
    n_layers = 6
    disps = np.sort(rng.uniform(dmin, dmax, n_layers))
    intervals = [(-10 * U, 10 * U)]
    for _ in range(1, n_layers):
        a = int(rng.integers(0, U - 10))
        b = a + int(rng.integers(8, U // 4))
        intervals.append((a, b))
    K = 8
    lams = np.exp(rng.uniform(np.log(6.0), np.log(60.0),
                              (n_layers, K))).astype(np.float32)
    amps = rng.uniform(0.3, 1.0, (n_layers, K)).astype(np.float32)
    amps *= 0.42 / np.abs(amps).sum(1, keepdims=True)
    phs = rng.uniform(0, 2 * np.pi, (n_layers, K)).astype(np.float32)
    u_idx = np.arange(U)
    shifts = (s_hat - np.arange(S))[None, :, None] * disps[:, None, None]
    u0 = u_idx[None, None, :] - shifts                 # [L, S, U]
    a = np.array([iv[0] for iv in intervals])[:, None, None]
    b = np.array([iv[1] for iv in intervals])[:, None, None]
    covers = (u0 >= a) & (u0 <= b)
    owner = np.where(covers.any(0),
                     (n_layers - 1) - np.argmax(covers[::-1], axis=0), 0)
    src = np.take_along_axis(u0, owner[None], 0)[0]    # [S, U]
    val0 = 0.55 + (np.sin(2 * np.pi * src[..., None] / lams[owner]
                          + phs[owner]) * amps[owner]).sum(-1).astype(
                              np.float32)
    return disps, owner, val0


def synthetic_sequence(S, V, U, seed, dmin, dmax, device):
    """The layered moving-strip light field, ``[V, S, U, 1]`` float32 on
    ``device``, and the true disparity per (s, u), ``[S, U]`` float32
    (numpy)."""
    rng = np.random.default_rng(seed)
    disps, owner, val0 = _layered_texture(rng, S, U, dmin, dmax)
    rowmod = rng.random((V,), dtype=np.float32) * 0.15
    vol = (torch.as_tensor(val0, device=device)[None, :, :, None]
           + torch.as_tensor(rowmod, device=device)[:, None, None, None])
    return vol, disps[owner].astype(np.float32)


def synthetic_sequence_bands(S, V, U, seed, dmin, dmax, device):
    """The four-band version: the gray scene's draws from the seed, in its
    order (the layers, then the row modulation x 0.15), and the volume
    ``val0 * BAND_GAINS[owner] + rowmod``, ``[V, S, U, 4]`` float32 on
    ``device``, with the true disparity ``[S, U]`` float32 (numpy)."""
    rng = np.random.default_rng(seed)
    disps, owner, val0 = _layered_texture(rng, S, U, dmin, dmax)
    rowmod = rng.random((V,), dtype=np.float32) * 0.15
    vol = (torch.as_tensor(val0, device=device)[None, :, :, None]
           * torch.as_tensor(BAND_GAINS[owner], device=device)[None]
           + torch.as_tensor(rowmod, device=device)[:, None, None, None])
    return vol, disps[owner].astype(np.float32)


def synthetic_sequence_rgb(S, V, U, seed, dmin, dmax, device):
    """The RGB version: per-layer RGB gains, quantised to uint8 as the
    reference reads the scene back from 8-bit PNGs, ``[V, S, U, 3]`` uint8
    on ``device``, and the true disparity ``[S, U]`` float32 (numpy).
    bench.py draws this scene's disparities in [0, 4] whatever the sweep's
    range, from ``seed + 101``; ``dmin`` and ``dmax`` are not read."""
    rng = np.random.default_rng(seed + 101)
    disps, owner, val0 = _layered_texture(rng, S, U, 0.0, 4.0)
    gains = rng.uniform(0.55, 1.0, (len(disps), 3)).astype(np.float32)
    rowmod = rng.random((V,), dtype=np.float32) * 0.12
    volf = (torch.as_tensor(val0, device=device)[None, :, :, None]
            * torch.as_tensor(gains[owner], device=device)[None]
            + torch.as_tensor(rowmod, device=device)[:, None, None, None])
    vol_u8 = torch.clamp(torch.round(volf * 255.0), 0, 255).to(torch.uint8)
    return vol_u8, disps[owner].astype(np.float32)


GENERATORS = {"synthetic_sequence": synthetic_sequence,
              "synthetic_sequence_rgb": synthetic_sequence_rgb,
              "synthetic_sequence_bands": synthetic_sequence_bands}


def make_scene(config: dict, seed: int, device):
    """The scene of a configuration file's entry, made from ``seed``:
    (volume ``[V, S, U, C]`` on ``device``, ground truth ``[S, U]``)."""
    gen = GENERATORS[config["scene"]]
    vol, gt = gen(config["S"], config["V"], config["U"], seed,
                  config["dmin"], config["dmax"], device)
    if vol.shape[-1] != config["C"]:
        raise ValueError(f"{config['name']}: the scene has {vol.shape[-1]} "
                         f"channels, the configuration states {config['C']}")
    return vol.contiguous(), gt
