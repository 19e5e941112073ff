"""The decomposition of the CUDA selective median (``csrc/median.cu``), on
the CPU against the plain version (``ops/median.py`` ``selective_median``)
and the JAX package.

The kernel works in tiles of TV x 32 output pixels.  A block stages the
(TV + size - 1) x (32 + size - 1) window of value, mask and colours, with
mask 0 (and zeros) outside the image; the colours come in stages of
channels, each tap's sum of squares carried from stage to stage in channel
order.  At sizes 3 and 5 the +inf-filled taps go through Batcher's odd-even
merge sort and element n // 2 is taken by a chain of selects; at the other
sizes the included values are sorted and element n // 2 taken.  The
PyTorch emulation below does exactly that and must equal the plain version
bit for bit, and the JAX package's XLA path (odd sizes: it pads the window
symmetrically and cannot take an even one) and Pallas kernel in interpret
mode.  The JAX networks of 81 and 289 taps take minutes to compile on the
CPU, so sizes 9 and 17 are held against the plain version only.
"""

import itertools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from remotesensingproject_tpu.ops.median import selective_median as j_med
from remotesensingproject_tpu.ops.median_pallas import selective_median_pallas
from remotesensingproject_tpu_torch.ops.median import selective_median
from remotesensingproject_tpu_torch.types import chan_scale

TILE_U = 32


def batcher(n):
    """Batcher's odd-even merge sort on n inputs, as the kernel's
    ``batcher`` builds it: the comparators of the next power-of-two network
    with both ends below n."""
    pairs = []
    p = 1
    while p < n:
        k = p
        while k >= 1:
            for j in range(k % p, n - k, 2 * k):
                for i in range(min(k, n - j - k)):
                    if (i + j) // (2 * p) == (i + j + k) // (2 * p):
                        pairs.append((i + j, i + j + k))
            k //= 2
        p *= 2
    return pairs


def tiled_median(src, frame, mask, size, eps, tile_v=8, nch=None):
    """The kernel's decomposition in PyTorch (``nch``: channels a stage)."""
    V, U = src.shape
    C = frame.shape[-1]
    nch = nch or C
    w = (size - 1) // 2
    cs = chan_scale(C)
    hv, hu = tile_v + size - 1, TILE_U + size - 1
    taps = [(dy, dx) for dy in range(size) for dx in range(size)]
    inf = torch.tensor(float("inf"))
    out = torch.full((V, U), float("nan"))
    for v0, u0 in itertools.product(range(0, V, tile_v), range(0, U, TILE_U)):
        # the window, mask 0 outside the image
        gv = torch.arange(v0 - w, v0 - w + hv)[:, None]
        gu = torch.arange(u0 - w, u0 - w + hu)[None, :]
        inside = (gv >= 0) & (gv < V) & (gu >= 0) & (gu < U)
        gv, gu = gv.clamp(0, V - 1), gu.clamp(0, U - 1)
        s_src = torch.where(inside, src[gv, gu], 0.0)
        s_mask = inside & mask[gv, gu]
        s_frame = torch.where(inside[..., None], frame[gv, gu], 0.0)

        def win(a, dy, dx):
            return a[dy:dy + tile_v, dx:dx + TILE_U]

        dsq = [None] * len(taps)
        for c0 in range(0, C, nch):
            for c in range(c0, min(C, c0 + nch)):
                fc = win(s_frame[..., c], w, w)
                for t, (dy, dx) in enumerate(taps):
                    d = fc - win(s_frame[..., c], dy, dx)
                    dsq[t] = d * d if c == 0 else dsq[t] + d * d
        vals = []
        n = torch.zeros((tile_v, TILE_U), dtype=torch.int64)
        for t, (dy, dx) in enumerate(taps):
            inc = win(s_mask, dy, dx) & (torch.sqrt(cs * dsq[t]) < eps)
            vals.append(torch.where(inc, win(s_src, dy, dx), inf))
            n += inc
        if size in (3, 5):
            for a, b in batcher(len(taps)):
                vals[a], vals[b] = (torch.minimum(vals[a], vals[b]),
                                    torch.maximum(vals[a], vals[b]))
        else:
            vals = list(torch.sort(torch.stack(vals), dim=0).values)
        pick = n // 2
        med = vals[0]
        for k in range(1, len(taps) // 2 + 1):
            med = torch.where(pick == k, vals[k], med)
        tile = torch.where(win(s_mask, w, w), med, 0.0)
        out[v0:v0 + tile_v, u0:u0 + TILE_U] = \
            tile[:V - v0, :U - u0]
    return out


def _inputs(seed, V, U, C, p_mask=0.6):
    rng = np.random.default_rng(seed)
    # values on a coarse grid so that ties occur, as with swept depths
    src = (rng.integers(-8, 17, (V, U)) / 8.0).astype(np.float32)
    frame = rng.uniform(0.3, 0.6, (V, U, C)).astype(np.float32)
    mask = rng.random((V, U)) < p_mask
    return src, frame, mask


def _torch(*arrays):
    return [torch.from_numpy(a) for a in arrays]


@pytest.mark.parametrize("n,count", [(9, 28), (25, 140)])
def test_batcher_network_sorts_every_zero_one_input(n, count):
    """0-1 principle: a comparator network that sorts every 0-1 input
    sorts every input.  Bit b of word k is input 64 k + b, whose value at
    position i is bit i of its number; min and max of 0-1 values are AND
    and OR, and a sorted 0-1 sequence never falls."""
    pairs = batcher(n)
    assert len(pairs) == count  # the kernel's static_assert
    one = np.uint64(1)
    low = [np.uint64(sum(1 << b for b in range(64) if (b >> i) & 1))
           for i in range(6)]
    for first in range(0, 1 << (n - 6), 1 << 16):
        k = np.arange(first, min(first + (1 << 16), 1 << (n - 6)),
                      dtype=np.uint64)
        pos = [np.full(k.shape, low[i]) if i < 6
               else np.where((k >> np.uint64(i - 6)) & one, ~np.uint64(0),
                             np.uint64(0)) for i in range(n)]
        for a, b in pairs:
            pos[a], pos[b] = pos[a] & pos[b], pos[a] | pos[b]
        for i in range(n - 1):
            assert not (pos[i] & ~pos[i + 1]).any()


@pytest.mark.parametrize("size", [1, 3, 4, 5, 9, 17])
@pytest.mark.parametrize("C", [1, 3, 4])
def test_tiles_equal_plain(size, C):
    # not multiples of the tile; (5, 7) is smaller than the 9 and 17 windows;
    # at eps 2 every colour test passes and the halo's mask alone decides
    for (V, U), eps in itertools.product([(13, 37), (5, 7), (20, 70)],
                                         [0.1, 2.0]):
        src, frame, mask = _torch(*_inputs(size * 10 + C + V, V, U, C))
        want = selective_median(src, frame, mask, size, eps)
        assert torch.equal(tiled_median(src, frame, mask, size, eps), want)


@pytest.mark.parametrize("size", [1, 3, 4, 5])
@pytest.mark.parametrize("C", [1, 3, 4])
def test_tiles_equal_jax(size, C):
    src, frame, mask = _inputs(size + 7 * C, 11, 41, C)
    got = tiled_median(*_torch(src, frame, mask), size, 0.1).numpy()
    args = (jnp.asarray(src), jnp.asarray(frame), jnp.asarray(mask), size,
            0.1)
    np.testing.assert_array_equal(
        got, np.asarray(selective_median_pallas(*args, interpret=True)))
    if size % 2:
        np.testing.assert_array_equal(got, np.asarray(j_med(*args)))


@pytest.mark.parametrize("tile_v,C,nch", [(4, 1, None), (1, 3, None),
                                          (2, 4, 3), (1, 7, 2), (8, 3, 1)])
@pytest.mark.parametrize("size", [3, 5, 6])
def test_smaller_tiles_and_channel_stages(tile_v, C, nch, size):
    """The launcher's plans for a large C: shorter tiles, then the
    channels in stages."""
    src, frame, mask = _torch(*_inputs(tile_v + C + size, 19, 45, C))
    want = selective_median(src, frame, mask, size, 0.15)
    assert torch.equal(
        tiled_median(src, frame, mask, size, 0.15, tile_v, nch), want)


@pytest.mark.parametrize("eps", [0.0, -0.5])
@pytest.mark.parametrize("size", [3, 4, 5])
def test_eps_not_positive_gives_inf_under_the_mask(eps, size):
    src, frame, mask = _torch(*_inputs(size, 12, 40, 3))
    got = tiled_median(src, frame, mask, size, eps)
    assert torch.equal(got, selective_median(src, frame, mask, size, eps))
    assert bool(torch.isinf(got[mask]).all()) and bool((got[~mask] == 0).all())
    if size % 2:
        want = j_med(jnp.asarray(src.numpy()), jnp.asarray(frame.numpy()),
                     jnp.asarray(mask.numpy()), size, eps)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("size", [4, 5, 9])
def test_all_false_mask_gives_zeros(size):
    src, frame, _ = _torch(*_inputs(size, 9, 40, 1))
    mask = torch.zeros((9, 40), dtype=torch.bool)
    got = tiled_median(src, frame, mask, size, 0.1)
    assert torch.equal(got, torch.zeros((9, 40)))
    assert torch.equal(got, selective_median(src, frame, mask, size, 0.1))
