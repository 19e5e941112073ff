"""The benchmark's frozen scene generators, bit for bit the port's."""

import numpy as np
import pytest
import torch

from benchmark import scenes
from remotesensingproject_tpu_torch import bench


@pytest.mark.parametrize("seed", [0, 7, 2 ** 31 + 5])
def test_gray_scene_is_the_ports(seed):
    vol, gt = scenes.synthetic_sequence(12, 10, 40, seed, -1.0, 4.0, "cpu")
    want, want_gt = bench.synthetic_sequence(12, 10, 40, seed=seed,
                                             dmin=-1.0, dmax=4.0,
                                             device="cpu")
    assert torch.equal(vol, want) and np.array_equal(gt, want_gt)


@pytest.mark.parametrize("seed", [0, 7, 2 ** 31 + 5])
def test_rgb_scene_is_the_ports(seed):
    vol, gt = scenes.synthetic_sequence_rgb(12, 10, 40, seed, 0.0, 4.0,
                                            "cpu")
    want, want_gt = bench.synthetic_sequence_rgb(12, 10, 40, seed=seed,
                                                 device="cpu")
    assert vol.dtype == torch.uint8
    assert torch.equal(vol, want) and np.array_equal(gt, want_gt)


@pytest.mark.parametrize("seed", [0, 7, 2 ** 31 + 5])
def test_band_scene_is_chip_smokes(seed, monkeypatch):
    """The four-band scene equals ``chip_smoke.py``'s phase-5 draw, its
    module shape patched to a small one."""
    import chip_smoke
    S, V, U = 12, 10, 40
    for name, value in (("S", S), ("V", V), ("U", U)):
        monkeypatch.setattr(chip_smoke, name, value)
    want, want_gt = chip_smoke.synthetic_sequence(
        torch, "cpu", seed=seed, gains=chip_smoke.BAND_GAINS)
    assert np.array_equal(scenes.BAND_GAINS, chip_smoke.BAND_GAINS)
    vol, gt = scenes.synthetic_sequence_bands(
        S, V, U, seed, chip_smoke.DMIN, chip_smoke.DMAX, "cpu")
    assert vol.shape == (V, S, U, 4) and vol.dtype == torch.float32
    assert torch.equal(vol, want) and np.array_equal(gt, want_gt)
    gray, _ = scenes.synthetic_sequence(S, V, U, seed, chip_smoke.DMIN,
                                        chip_smoke.DMAX, "cpu")
    assert not torch.equal(vol[..., :1], gray)
