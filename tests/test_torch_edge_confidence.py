"""Port parity: edge confidence vs the JAX package (mask exact, ce 1e-6)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import oracle
from remotesensingproject_tpu.config import DepthParams as JParams
from remotesensingproject_tpu.ops.edge_confidence import (
    edge_confidence_volume as j_edge)
from remotesensingproject_tpu_torch.config import DepthParams as TParams
from remotesensingproject_tpu_torch.ops.edge_confidence import (
    _ellipse_element, edge_confidence_volume as t_edge)


@pytest.mark.parametrize("C,opening,cut", [(1, 1, True), (3, 1, True),
                                            (1, 3, True), (1, 5, False)])
def test_edge_confidence_matches_jax(C, opening, cut):
    vol, _ = oracle.make_synthetic_lf(S=6, V=10, U=40, C=C, seed=C + opening)
    vol = vol / vol.max()
    # darken a patch so the shadow cut has work to do
    vol[2:5, :, 10:20] *= 0.02
    kw = dict(edge_confidence_opening_size=opening, cut_shadows=cut)
    ce_j, m_j = j_edge(jnp.asarray(vol), JParams(**kw))
    ce_t, m_t = t_edge(torch.from_numpy(vol), TParams(**kw))
    np.testing.assert_array_equal(m_t.numpy(), np.asarray(m_j))
    np.testing.assert_allclose(ce_t.numpy(), np.asarray(ce_j), rtol=0,
                               atol=1e-6)


@pytest.mark.parametrize("n", [1, 3, 4, 5, 7])
def test_ellipse_element_matches_jax(n):
    from remotesensingproject_tpu.ops.edge_confidence import (
        _ellipse_element as j_el)
    np.testing.assert_array_equal(_ellipse_element(n), j_el(n))
