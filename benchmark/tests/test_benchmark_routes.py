"""The check on the row and the tile sweep: the reference's row rule and
tile mode against the port's plain versions, a four-band cell through the
whole check, the faults each route can have, and the control."""

import dataclasses
import io
import json

import numpy as np
import pytest
import torch

from benchmark import check, harness, reference, scenes
from benchmark.hooks import Patches
from remotesensingproject_tpu_torch.config import DepthParams
from remotesensingproject_tpu_torch.models import depth2d
from remotesensingproject_tpu_torch.ops.sweep import sweep_pile
from remotesensingproject_tpu_torch.ops.sweep_pallas import (
    candidate_grid, sweep_rows_plain)
from remotesensingproject_tpu_torch.ops.sweep_pallas_perpixel import \
    tile_quantized_bounds

from .conftest import make_copy
from .test_benchmark_check import tiny_check
from .test_benchmark_cuda import need_card

D2 = "remotesensingproject_tpu_torch.models.depth2d"
#: the four-band test cell: three levels (V 44 -> 22 -> 11), the coarser
#: two of 600 / 2 and 600 / 4 columns, so their rows span three and two
#: tiles
BANDS = dict(S=9, V=44, U=600, C=4, D=9)


@pytest.fixture(scope="module")
def bands_root(tmp_path_factory):
    """A copy of the benchmark with the cell tiny.bands (the four-band
    scene at 9 x 44 x 600 x 4, D=9, edge score) added as files."""
    root = make_copy(tmp_path_factory.mktemp("bands"))
    here = root / "benchmark"
    conf = json.loads((here / "configs" / "skysat_lr18.json").read_text())
    conf.update(name="tiny_bands", scene="synthetic_sequence_bands",
                S=BANDS["S"], V=BANDS["V"], U=BANDS["U"], C=BANDS["C"],
                scene_seeds=[0])
    (here / "configs" / "tiny_bands.json").write_text(json.dumps(conf))
    (here / "traffic" / "tiny_bands.json").write_text(json.dumps(
        {"D": BANDS["D"], "params": {"score_version": "edge"}}))
    bench = json.loads((root / "BENCHMARK.json").read_text())
    bench["configs"].append({
        "name": "tiny_bands", "source": conf["source"],
        "file": "benchmark/configs/tiny_bands.json",
        "reduced": ["S", "V", "U", "C", "scene_seeds"], "why": "a test size"})
    bench["workloads"].append({"name": "tiny.bands", "config": "tiny_bands",
                               "traffic": "tiny_bands", "chips": 1,
                               "why": "a test size"})
    (root / "BENCHMARK.json").write_text(json.dumps(bench, indent=1))
    return root


# -- the reference's routes against the port's plain versions ---------------

def _volume(V, S, U, C, seed):
    g = torch.Generator().manual_seed(seed)
    return torch.rand((V, S, U, C), generator=g)


def _agree(want, port, v, u, with_allowed=False):
    """The reference's winner at every pixel (v, u) against the port's
    dense results there: no element differs beyond REL and ABS."""
    best = torch.argmax(check.competing(want), dim=1)
    take = torch.arange(best.numel())
    pairs = [(want["cand"][take, best], port.best_depth[v, u]),
             (want["score"][take, best], port.best_score[v, u]),
             (want["mean"], port.score_mean[v, u]),
             (want["rbar"][take, best], port.rbar[v, u]),
             (want["k"][take, best], port.k_best[v, :, u])]
    for got, ref_ in pairs:
        assert not check.differs(got, ref_).any()
    if with_allowed:
        assert want["allowed"][take, best].all()


@pytest.mark.parametrize("C", [2, 4])
@pytest.mark.parametrize("slope", [1.0, 0.5])
def test_row_rule_is_the_plain_row_sweep(C, slope):
    V, S, U, D, s_hat = 3, 7, 300, 13, 2
    epis = _volume(V, S, U, C, C)
    params = DepthParams().with_slope_factor(slope)
    port = sweep_rows_plain(epis, candidate_grid(-1.0, 4.0, D, "cpu"),
                            s_hat, params, with_k_best=True)
    v, u = torch.meshgrid(torch.arange(V), torch.arange(U), indexing="ij")
    v, u = v.reshape(-1), u.reshape(-1)
    full = torch.full(v.shape, reference.f32(-1.0))
    want = reference.sweep_pixels(
        epis, v, u, full, torch.full(v.shape, reference.f32(4.0)), D, s_hat,
        slope, 10, with_k=True, rule="row")
    _agree(want, port, v, u)
    # the row rule is not the pixel rule: some sample's weight differs
    pixel = reference.sweep_pixels(
        epis, v, u, full, torch.full(v.shape, reference.f32(4.0)), D, s_hat,
        slope, 10, with_k=True)
    assert not torch.equal(pixel["k"], want["k"])


@pytest.mark.parametrize("C", [2, 4])
def test_tile_mode_is_the_plain_masked_sweep(C):
    V, S, U, D, s_hat = 4, 7, 300, 9, 3
    rng = np.random.default_rng(C)
    epis = _volume(V, S, U, C, 10 + C)
    active = torch.as_tensor(rng.random((V, U)) < 0.4)
    active[1] = False                  # a row with no active pixel
    active[2, :150] = False            # a tile with none
    lo = torch.as_tensor(rng.uniform(-1.0, 2.0, (V, U)).astype(np.float32))
    hi = lo + torch.as_tensor(rng.uniform(0.0, 2.0, (V, U))
                              .astype(np.float32))
    glo, ghi = reference.tile_grid(active, lo, hi, (-1.0, 4.0))
    qlo, qhi = tile_quantized_bounds(active, lo, hi, (-1.0, 4.0))
    assert torch.equal(glo, qlo) and torch.equal(ghi, qhi)
    assert torch.equal(glo[2, :128], torch.full((128,), -1.0))
    assert (glo[0, 1:] != glo[0, :-1]).sum() == 2      # three tiles a row
    params = DepthParams().with_slope_factor(0.5)
    port = sweep_pile(epis, qlo, qhi, D, s_hat, params, with_k_best=True,
                      pdmin_v_u=lo, pdmax_v_u=hi)
    v, u = torch.nonzero(active, as_tuple=True)
    want = reference.sweep_pixels(
        epis, v, u, glo[v, u], ghi[v, u], D, s_hat, 0.5, 10, with_k=True,
        plo=lo[v, u], phi=hi[v, u])
    _agree(want, port, v, u, with_allowed=True)
    assert not want["allowed"].all()


# -- the four-band cell through the whole check ------------------------------

def test_band_cell_reads_nothing_and_control_fails(bands_root, monkeypatch):
    calls = {"sweep_pile_rows": 0, "sweep_pile_tiles": 0}
    for name in calls:
        def counted(*a, _orig=getattr(depth2d, name), _name=name, **k):
            calls[_name] += 1
            return _orig(*a, **k)
        monkeypatch.setattr(depth2d, name, counted)
    cell, chk = tiny_check(bands_root, "tiny.bands", 17, control=True)
    assert chk.n_levels >= 3 and chk.checked_passes >= 5
    assert all(calls.values()), calls
    assert all(v == 0.0 for v in chk.readings.values()), chk.readings
    over = [n for n, v in chk.control_readings.items()
            if v > cell.limits[n]]
    assert {"sweep_gap", "sweep_err"} & set(over), chk.control_readings


def test_band_cell_record_is_correct(bands_root):
    rec = harness.run_cell(bands_root, "tiny.bands", 2 ** 31 + 9, 0.01,
                           False, "cpu", out=io.StringIO())
    assert rec["correct"], rec["checks"]
    assert all(c["value"] == 0.0 for c in rec["checks"].values())


def _grid_over_all_pixels(orig):
    def bounds(active, dmin_v_u, dmax_v_u, d_bounds):
        return orig(torch.ones_like(active), dmin_v_u, dmax_v_u, d_bounds)
    return bounds


def _mask_dropped(orig):
    def tiles(*a, **k):
        k.pop("pdmin_v_u", None)
        k.pop("pdmax_v_u", None)
        return orig(*a, **k)
    return tiles


def _tiles_at_first_active(orig):
    """Each row's tiles start at its first active pixel instead of u = 0."""
    def bounds(active, dmin_v_u, dmax_v_u, d_bounds):
        qlo, qhi = (torch.full_like(dmin_v_u, reference.f32(b))
                    for b in d_bounds)
        for v in range(active.shape[0]):
            cols = torch.nonzero(active[v]).reshape(-1)
            if cols.numel() == 0:
                continue
            o = int(cols[0])
            lo, hi = orig(active[v:v + 1, o:], dmin_v_u[v:v + 1, o:],
                          dmax_v_u[v:v + 1, o:], d_bounds)
            qlo[v, o:], qhi[v, o:] = lo[0], hi[0]
        return qlo, qhi
    return bounds


def _rows_off_by_a_step(orig):
    def rows(epis, dmin, dmax, dim_d, *a, **k):
        step = (dmax - dmin) / (dim_d - 1)
        return orig(epis, dmin + step, dmax + step, dim_d, *a, **k)
    return rows


ROUTE_FAULTS = {
    "grid_over_all_pixels": (f"{D2}:tile_quantized_bounds",
                             _grid_over_all_pixels),
    "mask_dropped": (f"{D2}:sweep_pile_tiles", _mask_dropped),
    "tiles_at_first_active": (f"{D2}:tile_quantized_bounds",
                              _tiles_at_first_active),
    "rows_off_by_a_step": (f"{D2}:sweep_pile_rows", _rows_off_by_a_step),
}


def _follow_every_pass(monkeypatch):
    """The check follows every pass instead of the passes it draws, so
    that the draw does not decide whether a pass the fault moves is
    followed (a fault in the tile grid moves only some passes of a level
    at this size)."""
    init = check.Check.__init__

    def every_pass(self, scene, passes, seed, control=False):
        init(self, scene, passes, seed, control)
        self.samples = {(p, j) for p, n in enumerate(passes)
                        for j in range(n)}
    monkeypatch.setattr(check.Check, "__init__", every_pass)


@pytest.mark.parametrize("fault", sorted(ROUTE_FAULTS))
def test_a_route_fault_reads_above_its_limit(bands_root, fault,
                                             monkeypatch):
    _follow_every_pass(monkeypatch)
    target, make = ROUTE_FAULTS[fault]
    with Patches() as p:
        assert p.wrap(target, make)
        cell, chk = tiny_check(bands_root, "tiny.bands", 19)
    over = {n for n in ("sweep_gap", "sweep_err")
            if not chk.readings[n] <= cell.limits[n]}
    assert over, chk.readings


def test_routes_follow_the_scene_and_the_level():
    vol = torch.zeros((12, 5, 30, 4))
    sc = check.Scene(vol=vol, dmin=-1.0, dmax=4.0, D=9,
                     score_version="edge", steps=10, interpolation="linear")
    chk = check.Check(sc, [3, 3], 1)
    chk.bounds = None
    assert chk.sweep_route() == "row"
    chk.bounds = (vol, vol)
    assert chk.sweep_route() == "tile"
    chk.scene = dataclasses.replace(sc, interpolation="nearest")
    assert chk.sweep_route() == "pixel"
    for C, D, route in ((1, 9, "pixel"), (3, 1024, "pixel"),
                        (3, 1025, "tile"), (2, 9, "tile")):
        chk.scene = dataclasses.replace(
            sc, vol=torch.zeros((12, 5, 30, C)), D=D)
        assert chk.sweep_route() == route, (C, D)


@pytest.mark.cuda
def test_band_cell_on_the_card(bands_root):
    need_card()
    cell, chk = tiny_check(bands_root, "tiny.bands", 29, control=True,
                           device="cuda")
    assert all(v == 0.0 for v in chk.readings.values()), chk.readings
    assert [n for n, v in chk.control_readings.items()
            if v > cell.limits[n]]

