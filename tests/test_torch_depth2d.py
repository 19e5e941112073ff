"""Port parity: one pass from a state carried across, and the whole
Depth2DComputer, vs the JAX package's XLA path.  Claims and masks are
exact; depth within 1e-4 and disp_conf within 2e-3, the tolerances of
tests/test_depth2d_pallas.py; in line mode line_conf within 1e-5 (the
bound of tests/test_variants.py:305)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import oracle
from remotesensingproject_tpu.config import DepthParams as JParams
from remotesensingproject_tpu.models import depth2d as jd
from remotesensingproject_tpu.ops.edge_confidence import (
    edge_confidence_volume as j_edge)
from remotesensingproject_tpu.ops.normalize import normalize_volume as j_norm
from remotesensingproject_tpu_torch.config import DepthParams, params_from
from remotesensingproject_tpu_torch.models import depth2d as td

DMIN, DMAX = -1.0, 1.5


def _edited_bounds(S, V, U, seed=7):
    rng = np.random.default_rng(seed)
    center = rng.uniform(DMIN, DMAX, (V, U)).astype(np.float32)
    lo = np.clip(center - 0.3, DMIN, DMAX)
    hi = np.clip(center + 0.3, DMIN, DMAX)
    unref = rng.random((V, U)) < 0.3
    lo[unref], hi[unref] = DMIN, DMAX
    return (np.ascontiguousarray(np.broadcast_to(lo, (S, V, U))),
            np.ascontiguousarray(np.broadcast_to(hi, (S, V, U))))


def _compare_states(ref, out, exact=("claim", "ce_mask")):
    for name in exact:
        np.testing.assert_array_equal(getattr(out, name).numpy(),
                                      np.asarray(getattr(ref, name)), name)
    for name, atol in (("best_depth", 1e-4), ("disp_conf", 2e-3),
                       ("ce", 1e-6)):
        np.testing.assert_allclose(getattr(out, name).numpy(),
                                   np.asarray(getattr(ref, name)), rtol=0,
                                   atol=atol, err_msg=name)


@pytest.mark.parametrize("edited,score", [(False, "edge"), (True, "edge"),
                                          (False, "disp"), (False, "line"),
                                          (True, "line")])
def test_one_pass_from_carried_state(edited, score):
    vol, _ = oracle.make_synthetic_lf(S=8, V=6, U=64, C=1, seed=3,
                                      dmin=DMIN, dmax=DMAX)
    jparams = JParams(score_version=score)
    params = params_from(jparams, DepthParams)
    D = 9
    epis = j_norm(jnp.asarray(vol))
    frames = jnp.transpose(epis, (1, 0, 2, 3))
    V, S, U, C = epis.shape
    ce, mask = j_edge(epis, jparams)
    ce = jnp.transpose(ce, (1, 0, 2))
    mask = jnp.transpose(mask, (1, 0, 2))
    state = jd.Depth2DState(
        ce=ce, ce_mask=mask, disp_conf=jnp.zeros((S, V, U)),
        line_conf=jnp.zeros((S, V, U) if score == "line" else (1, 1, 1)),
        best_depth=jnp.zeros((S, V, U)),
        rbar=jnp.zeros((S, V, U, C)), claim=mask)
    if edited:
        lo, hi = _edited_bounds(S, V, U)
    else:
        lo, hi = (np.full((S, V, U), DMIN, np.float32),
                  np.full((S, V, U), DMAX, np.float32))
    kw = dict(dim_d=D, params=jparams, d_bounds=(DMIN, DMAX),
              use_pallas=False, uniform_bounds=not edited)
    sched = jd.center_outward_schedule(S)
    args = (epis, frames, jnp.asarray(lo), jnp.asarray(hi), jnp.zeros(1))
    for s_hat in sched[:2]:
        state = jd._pass_fn(*args, state, s_hat, **kw)
    carried = {k: np.asarray(v) for k, v in state._asdict().items()}
    ref = jd._pass_fn(*args, state, sched[2], **kw)

    port = td.state_from_numpy(carried, "cpu")
    bounds = {}
    if edited:
        bounds = dict(dmin_s_v_u=torch.from_numpy(lo),
                      dmax_s_v_u=torch.from_numpy(hi))
    out = td._pass_fn(torch.from_numpy(np.array(epis)),
                      torch.from_numpy(np.array(frames)),
                      port, sched[2], dim_d=D, params=params,
                      d_bounds=(DMIN, DMAX), **bounds)
    # the pass did work: it swept or painted something
    assert not np.array_equal(np.asarray(ref.best_depth),
                              carried["best_depth"])
    _compare_states(ref, out)
    np.testing.assert_allclose(out.rbar.numpy(), np.asarray(ref.rbar),
                               rtol=0, atol=2e-5)
    np.testing.assert_allclose(out.line_conf.numpy(),
                               np.asarray(ref.line_conf), rtol=0, atol=1e-5)
    if score == "line":
        # the pass refreshed C_l at the s_hat plane and painted it on
        assert np.asarray(ref.line_conf)[sched[2]].any()
        assert (np.asarray(ref.line_conf) != carried["line_conf"]).sum() > \
            (np.asarray(ref.line_conf)[sched[2]] != carried["line_conf"][
                sched[2]]).sum()


@pytest.mark.parametrize("edited", [False, True])
def test_depth2d_computer_matches_jax(edited):
    vol, _ = oracle.make_synthetic_lf(S=8, V=6, U=160, C=1, seed=5,
                                      dmin=DMIN, dmax=DMAX)
    jc = jd.Depth2DComputer(jnp.asarray(vol), DMIN, DMAX, 7,
                            use_pallas=False)
    tc = td.Depth2DComputer(vol, DMIN, DMAX, 7, device="cpu")
    if edited:
        lo, hi = _edited_bounds(8, 6, 160)
        jc.set_bounds(jnp.asarray(lo), jnp.asarray(hi))
        tc.set_bounds(torch.from_numpy(lo), torch.from_numpy(hi))
    jc.run()
    tc.run()
    _compare_states(jc.state, tc.state)
    np.testing.assert_array_equal(
        tc.get_valid_depths_mask_s_v_u().numpy(),
        np.asarray(jc.get_valid_depths_mask_s_v_u()))


@pytest.mark.parametrize("S", [1, 2, 7, 8])
def test_schedule_matches_jax(S):
    assert td.center_outward_schedule(S) == jd.center_outward_schedule(S)
    if S % 2 == 0:
        assert 0 not in td.center_outward_schedule(S)


def test_accept_all_validity():
    vol, _ = oracle.make_synthetic_lf(S=4, V=4, U=24, C=1, seed=1)
    tc = td.Depth2DComputer(vol, DMIN, DMAX, 5, device="cpu")
    tc.set_accept_all(True)
    tc.run()
    assert bool(tc.get_valid_depths_mask_s_v_u().all())
