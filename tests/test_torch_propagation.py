"""Port parity: line painting, bitwise vs the JAX package's XLA path
(dense and candidate-bucket scans) and its Pallas kernel in interpret
mode."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from remotesensingproject_tpu.ops.propagation import propagate as j_prop
from remotesensingproject_tpu.ops.propagation_pallas import propagate_pallas
from remotesensingproject_tpu_torch.ops.propagation import propagate
from remotesensingproject_tpu_torch.ops.propagation_pallas import (
    propagate_cuda)
from remotesensingproject_tpu_torch.ops.sweep import candidate_disparities

DMIN, DMAX = -1.0, 1.5


def _inputs(seed, S=7, V=5, U=48, C=1, dim_d=11):
    rng = np.random.default_rng(seed)
    claim = rng.random((S, V, U)) < 0.7
    frames = rng.uniform(0.3, 0.5, (S, V, U, C)).astype(np.float32)
    grid = candidate_disparities(DMIN, DMAX, dim_d)
    depth = grid[rng.integers(0, dim_d, (V, U))]
    rbar = frames[S // 2] + rng.normal(0, 0.02, (V, U, C)).astype(np.float32)
    sm = rng.random((V, U)) < 0.5
    conf = rng.uniform(0, 1, (V, U)).astype(np.float32)
    tgt_d = rng.uniform(-1, 1, (S, V, U)).astype(np.float32)
    tgt_c = rng.uniform(0, 1, (S, V, U)).astype(np.float32)
    return claim, frames, depth, rbar, sm, conf, tgt_d, tgt_c


def _run_port(fn, inp, s_hat, slope, eps):
    claim, frames, depth, rbar, sm, conf, tgt_d, tgt_c = [
        torch.from_numpy(np.array(x)) for x in inp]
    cl, (d, c) = fn(claim, frames, depth, rbar, sm, s_hat, slope, eps,
                    [(tgt_d, depth), (tgt_c, conf)])
    return cl.numpy(), d.numpy(), c.numpy()


def _check(got, want):
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, np.asarray(w))


@pytest.mark.parametrize("seed,s_hat,slope,C,buckets",
                         [(0, 3, 1.0, 1, False), (1, 0, 1.0, 1, True),
                          (2, 6, 0.5, 3, False), (3, 3, 2.0, 1, True),
                          (4, 2, 1.0, 4, False)])
def test_propagate_bitwise_vs_xla(seed, s_hat, slope, C, buckets):
    dim_d = 11
    inp = _inputs(seed, C=C, dim_d=dim_d)
    claim, frames, depth, rbar, sm, conf, tgt_d, tgt_c = inp
    cl, (d, c) = j_prop(jnp.asarray(claim), jnp.asarray(frames),
                        jnp.asarray(depth), jnp.asarray(rbar),
                        jnp.asarray(sm), jnp.int32(s_hat), (DMIN, DMAX),
                        slope, 0.1,
                        [(jnp.asarray(tgt_d), jnp.asarray(depth)),
                         (jnp.asarray(tgt_c), jnp.asarray(conf))],
                        dim_d=dim_d if buckets else 0)
    got = _run_port(propagate, inp, s_hat, slope, 0.1)
    assert (got[0] != claim).any()  # something was painted
    _check(got, (cl, d, c))
    _check(_run_port(propagate_cuda, inp, s_hat, slope, 0.1), (cl, d, c))


@pytest.mark.parametrize("seed,C", [(5, 1), (6, 3), (7, 4)])
def test_propagate_bitwise_vs_pallas_interpret(seed, C):
    inp = _inputs(seed, C=C)
    claim, frames, depth, rbar, sm, conf, tgt_d, tgt_c = inp
    cl, (d, c) = propagate_pallas(
        jnp.asarray(claim), jnp.asarray(frames), jnp.asarray(depth),
        jnp.asarray(rbar), jnp.asarray(sm), jnp.int32(2), (DMIN, DMAX), 1.0,
        0.1, [(jnp.asarray(tgt_d), jnp.asarray(depth)),
              (jnp.asarray(tgt_c), jnp.asarray(conf))], interpret=True)
    _check(_run_port(propagate_cuda, inp, 2, 1.0, 0.1), (cl, d, c))


def test_propagate_without_sources_is_a_no_op():
    inp = list(_inputs(9))
    inp[4] = np.zeros_like(inp[4])
    claim, _, _, _, _, _, tgt_d, tgt_c = inp
    _check(_run_port(propagate, inp, 3, 1.0, 0.1), (claim, tgt_d, tgt_c))


def test_propagate_three_payloads_bitwise_vs_xla():
    """Line mode's third payload (line_conf) is painted under the same
    condition as the other two."""
    claim, frames, depth, rbar, sm, conf, tgt_d, tgt_c = _inputs(8, C=3)
    rng = np.random.default_rng(18)
    line = rng.uniform(0, 1, depth.shape).astype(np.float32)
    tgt_l = rng.uniform(0, 1, tgt_d.shape).astype(np.float32)
    srcs, tgts = (depth, conf, line), (tgt_d, tgt_c, tgt_l)
    cl, targets = j_prop(jnp.asarray(claim), jnp.asarray(frames),
                         jnp.asarray(depth), jnp.asarray(rbar),
                         jnp.asarray(sm), jnp.int32(3), (DMIN, DMAX), 1.0,
                         0.1, [(jnp.asarray(t), jnp.asarray(s))
                               for t, s in zip(tgts, srcs)])
    for fn in (propagate, propagate_cuda):
        t_cl = torch.from_numpy(claim.copy())
        t_tg = [torch.from_numpy(t.copy()) for t in tgts]
        fn(t_cl, torch.from_numpy(frames), torch.from_numpy(depth),
           torch.from_numpy(rbar), torch.from_numpy(sm), 3, 1.0, 0.1,
           [(t, torch.from_numpy(s)) for t, s in zip(t_tg, srcs)])
        assert (t_cl.numpy() != claim).any()
        _check([t_cl.numpy(), *(t.numpy() for t in t_tg)], (cl, *targets))
