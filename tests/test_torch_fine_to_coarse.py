"""Port parity: FineToCoarse end to end vs the JAX package's XLA path,
at the sizes of tests/test_fine_to_coarse.py, float and uint8 input.
Validity exact; fused depth within 1e-4 (the Depth2DComputer tolerance)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import oracle
from remotesensingproject_tpu.config import PyramidParams as JPyr
from remotesensingproject_tpu.models.fine_to_coarse import (
    FineToCoarse as JFTC)
from remotesensingproject_tpu_torch.config import PyramidParams
from remotesensingproject_tpu_torch.models.fine_to_coarse import FineToCoarse


def test_levels_and_shapes():
    vol, _ = oracle.make_synthetic_lf(S=6, V=24, U=44, C=1, n_objects=3,
                                      seed=1)
    ftc = FineToCoarse(vol, -1.0, 1.5, 5,
                       pyramid=PyramidParams(min_spatial_dim=10),
                       device="cpu")
    assert len(ftc.computers) == 2
    assert tuple(ftc.computers[0].epis.shape[:3]) == (24, 6, 44)
    assert tuple(ftc.computers[1].epis.shape[:3]) == (12, 6, 22)
    assert np.isclose(ftc.level_params[1].slope_factor, 22 / 44)
    assert ftc.computers[-1].accept_all


@pytest.mark.parametrize("uint8", [False, True])
def test_fine_to_coarse_matches_jax(uint8):
    vol, gt = oracle.make_synthetic_lf(S=8, V=24, U=40, C=1, n_objects=3,
                                       seed=4, dmin=-1.0, dmax=1.5)
    if uint8:
        vol = np.clip(np.round(vol * 255.0), 0, 255).astype(np.uint8)
    j = JFTC(jnp.asarray(vol), -1.0, 1.5, 21,
             pyramid=JPyr(min_spatial_dim=10), use_pallas=False)
    j.run()
    fj, vj = j.get_results()
    t = FineToCoarse(vol, -1.0, 1.5, 21,
                     pyramid=PyramidParams(min_spatial_dim=10), device="cpu")
    t.run()
    ft, vt = t.get_results()
    for cj, ct in zip(j.computers, t.computers):
        np.testing.assert_allclose(ct.epis.numpy(), np.asarray(cj.epis),
                                   rtol=0, atol=1e-6)
        np.testing.assert_array_equal(ct.state.claim.numpy(),
                                      np.asarray(cj.state.claim))
    np.testing.assert_array_equal(vt.numpy(), np.asarray(vj))
    np.testing.assert_allclose(ft.numpy(), np.asarray(fj), rtol=0, atol=1e-4)
    # and the fused map recovers the scene
    err = np.abs(ft.numpy()[4] - gt)
    assert np.median(err) < 0.15
    assert isinstance(ft, torch.Tensor) and ft.dtype == torch.float32
