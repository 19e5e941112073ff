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
