"""Port parity: types, config and normalization vs the JAX package."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from remotesensingproject_tpu import config as jcfg
from remotesensingproject_tpu import types as jtypes
from remotesensingproject_tpu.ops.normalize import normalize_volume as j_norm
from remotesensingproject_tpu_torch import config as tcfg
from remotesensingproject_tpu_torch import types as ttypes
from remotesensingproject_tpu_torch.ops.normalize import (
    normalize_volume as t_norm)


@pytest.mark.parametrize("name", ["DepthParams", "PyramidParams"])
def test_config_fields_and_defaults_equal(name):
    jc, tc = getattr(jcfg, name), getattr(tcfg, name)
    jf = [(f.name, f.default) for f in dataclasses.fields(jc)]
    tf = [(f.name, f.default) for f in dataclasses.fields(tc)]
    assert jf == tf
    # field-by-field conversion of a non-default JAX instance
    changed = dataclasses.replace(jc(), **{jf[1][0]: jf[1][1] * 2})
    assert dataclasses.asdict(tcfg.params_from(changed, tc)) == \
        dataclasses.asdict(changed)


def test_with_slope_factor_and_constants():
    p = tcfg.DEFAULT_PARAMS.with_slope_factor(0.25)
    assert p.slope_factor == 0.25
    assert ttypes.SQRT3 == jtypes.SQRT3
    assert ttypes.SHADOW_NORMALIZED_LEVEL == jtypes.SHADOW_NORMALIZED_LEVEL
    assert ttypes.chan_scale(1) == jtypes.chan_scale(1) == 3.0
    assert ttypes.chan_scale(3) == jtypes.chan_scale(3) == 1.0


def test_round_half_away_on_halves():
    k = np.arange(-6, 7, dtype=np.float32)
    x = np.concatenate([k + 0.5, k - 0.5, k, k + 0.25, k - 0.75])
    got = ttypes.round_half_away(torch.from_numpy(x)).numpy()
    want = np.asarray(jtypes.round_half_away(jnp.asarray(x)))
    np.testing.assert_array_equal(got, want)
    # std::round: halves go away from zero, unlike torch.round
    np.testing.assert_array_equal(
        ttypes.round_half_away(torch.tensor([0.5, -0.5, 2.5, -2.5])).numpy(),
        [1.0, -1.0, 3.0, -3.0])


@pytest.mark.parametrize("C", [1, 3])
def test_norms_match(C):
    x = np.random.default_rng(C).normal(size=(7, 5, C)).astype(np.float32)
    np.testing.assert_array_equal(
        ttypes.normsq(torch.from_numpy(x)).numpy(),
        np.asarray(jtypes.normsq(jnp.asarray(x))))
    np.testing.assert_allclose(
        ttypes.norm(torch.from_numpy(x)).numpy(),
        np.asarray(jtypes.norm(jnp.asarray(x))), rtol=1e-7)


@pytest.mark.parametrize("kind", ["uint8", "float", "scaled"])
def test_normalize_volume(kind):
    rng = np.random.default_rng(3)
    if kind == "uint8":
        v = rng.integers(0, 256, (4, 5, 6, 1)).astype(np.uint8)
    else:
        v = rng.uniform(0, 7, (4, 5, 6, 1)).astype(np.float32)
    sf = 5.0 if kind == "scaled" else -1.0
    got = t_norm(torch.from_numpy(v), sf).numpy()
    want = np.asarray(j_norm(jnp.asarray(v), sf))
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-7)
    assert got.dtype == np.float32
