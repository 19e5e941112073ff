"""Whether the timed path produced the right scene: the comparison that
decides ``correct``.

Once the window has closed, the scene is run once more, untimed, with the
benchmark's hooks on the port's pass loop, and the plain reference
(``reference.py``) follows it step by step:

* ``level_err``: every pyramid level's normalized volume, worked out again
  from the input volume;
* ``edge_err``: every level's starting state (edge confidence, its mask,
  the claim mask, zeroed planes), worked out again from that volume;
* ``bounds_err``: every coarser level's per-pixel bounds, worked out again
  from the program's finished parent level;
* at passes drawn from the seed (the first of level 0, two more of level
  0, one of each coarser level), from the program's state at the start of
  the pass: ``sweep_gap`` and ``sweep_err``, the sweep at pixels drawn from
  the pass's active ones (how far below the reference's best score the
  program's pick lies, and how far its score, mean score, r_bar, depth and
  k_best lie from the reference's at that pick); ``median_miss``, the
  selective median; ``pass_miss``, the merge, line confidence and paint
  (every plane of the state after the pass);
* ``fusion_err``: the timed scene's fused map and validity against the
  reference's fusion of the replayed levels, which also ties the replay to
  the window.

The sampled sweep follows the route the program's ``sweep_pass`` takes
(``models/depth2d.py:122-171`` of the port), decided from the scene and the
level alone, in this order:

* C in {1, 3} and D <= 1024: the pixel kernel, each pixel on its own grid
  with its own sample positions (the reference's pixel rule; fast mode caps
  its mean shift);
* nearest interpolation: the tile kernel on each pixel's own grid (the
  level's bounds at the uniform level), the same pixel rule;
* the uniform level (level 0, no per-pixel bounds): the row kernel, one
  shift a (frame, candidate) for every column (the reference's row rule);
* a bounds-edited level: the tile kernel in tile mode, the default of
  ``FineToCoarse`` and of the CLI: a grid shared by each 128-column tile,
  aligned at u = 0, from the least and greatest bound of the pass's active
  pixels in it (``reference.tile_grid``; the JAX package's
  ``models/depth2d.py:405-414``), each pixel's own range masking the
  candidates that may win and count in the mean.

The row and the tile kernel never cap the mean shift.  The control follows
the same route.

The reference reads the program's state only where it follows a pass from
it; it works out the volumes, the bounds, the validity and every pass's
result itself.  ``control=True`` also puts the reference computed in
bfloat16 in the program's place at each of those steps and reads the same
numbers (the control, for ``control.py``).
"""

from __future__ import annotations

import dataclasses
import inspect
from typing import Callable, List, Optional

import numpy as np
import torch

from . import counts
from . import reference as ref
from .hooks import Patches

F32 = torch.float32
BF16 = torch.bfloat16

PORT = "remotesensingproject_tpu_torch"
#: the seams of the port the replay follows
TARGETS = dict(
    level=f"{PORT}.models.depth2d:Depth2DComputer.run",
    pass_=f"{PORT}.models.depth2d:_pass_fn",
    sweep=f"{PORT}.models.depth2d:sweep_pass",
    median=f"{PORT}.models.depth2d:selective_median_cuda",
)
STATE_PLANES = ("ce", "ce_mask", "disp_conf", "line_conf", "best_depth",
                "rbar", "claim")

NUMBERS = ("level_err", "edge_err", "bounds_err", "sweep_gap", "sweep_err",
           "median_miss", "pass_miss", "fusion_err")

#: pixels of a sampled pass the reference sweeps
SWEEP_PIXELS = 2048
#: further passes of level 0 drawn, besides its first
LEVEL0_DRAWS = 2
#: two floats agree within REL of the reference's magnitude plus ABS
REL, ABS = 1e-5, 1e-7
#: the channel counts and the most candidates the pixel kernel takes
#: (``ops/sweep_pallas_pixel.py`` ``MAX_DIM_D`` of the port)
PIXEL_KERNEL_C, PIXEL_KERNEL_MAX_D = (1, 3), 1024


def differs(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Elementwise: ``a`` is not ``b`` (bools exactly; floats within REL
    and ABS; NaN equals NaN)."""
    if a.dtype == torch.bool or b.dtype == torch.bool:
        return a != b
    a, b = a.float(), b.float()
    same = (a == b) | (torch.isnan(a) & torch.isnan(b))
    return ~(same | (torch.abs(a - b) <= REL * torch.abs(b) + ABS))


def share(mask: torch.Tensor, of: int) -> float:
    return float(mask.sum()) / max(1, of)


@dataclasses.dataclass
class Scene:
    """What the check needs of a cell."""

    vol: torch.Tensor        # [V, S, U, C] input volume, on the device
    dmin: float
    dmax: float
    D: int
    score_version: str
    steps: int               # mean-shift steps
    interpolation: str


class Check:
    """The readings of one replay (``readings``; with ``control``, also
    ``control_readings``)."""

    def __init__(self, scene: Scene, passes: List[int], seed: int,
                 control: bool = False):
        self.scene = scene
        self.control = control
        self.rng = np.random.default_rng([seed & 0xFFFFFFFFFFFF, 0xC0EC])
        self.readings = {n: 0.0 for n in NUMBERS}
        self.control_readings = {n: 0.0 for n in NUMBERS}
        self.samples = {(0, 0)}
        if passes and passes[0] > 1:
            draws = self.rng.choice(np.arange(1, passes[0]),
                                    size=min(LEVEL0_DRAWS, passes[0] - 1),
                                    replace=False)
            self.samples |= {(0, int(j)) for j in draws}
        for p, n in enumerate(passes[1:], start=1):
            self.samples.add((p, int(self.rng.integers(0, max(n, 1)))))
        self.n_levels = ref.level_count(scene.vol.shape[0], scene.vol.shape[2])
        self._inputs = ref.pyramid_inputs(scene.vol)
        self._inputs_ctl = ref.pyramid_inputs(scene.vol, BF16) \
            if control else None
        self.level = -1
        self.finals: List[dict] = []     # program's finished levels
        self.valids: List[torch.Tensor] = []
        self.checked_passes = 0
        self._armed: Optional[dict] = None

    # -- bookkeeping -------------------------------------------------------

    def _read(self, name: str, value: float, ctl: Optional[float] = None):
        self.readings[name] = max(self.readings[name], float(value))
        if ctl is not None:
            self.control_readings[name] = max(self.control_readings[name],
                                              float(ctl))

    # -- hooks ---------------------------------------------------------------

    def install(self, patches: Patches) -> bool:
        ok = patches.wrap(TARGETS["level"], self._wrap_level)
        ok &= patches.wrap(TARGETS["pass_"], self._wrap_pass)
        ok &= patches.wrap(TARGETS["sweep"], self._wrap_capture("res"))
        ok &= patches.wrap(TARGETS["median"], self._wrap_capture("filtered"))
        return ok

    def _wrap_capture(self, key: str):
        def make(orig):
            def captured(*a, **k):
                out = orig(*a, **k)
                if self._armed is not None:
                    self._armed[key] = out
                return out
            return captured
        return make

    def _wrap_level(self, orig):
        def run(computer, *a, **k):
            self._start_level(computer)
            out = orig(computer, *a, **k)
            self._finish_level(computer)
            return out
        return run

    def _wrap_pass(self, orig):
        sig = inspect.signature(orig)

        def pass_fn(*a, **k):
            args = sig.bind(*a, **k).arguments
            state, s_hat = args["state"], int(args["s_hat"])
            if self.pass_index == 0:
                self._check_start(state)
            sampled = (self.level, self.pass_index) in self.samples
            pre = None
            if sampled:
                pre = {n: getattr(state, n).clone() for n in STATE_PLANES}
                self._armed = {}
            try:
                out = orig(*a, **k)
            finally:
                captured, self._armed = self._armed, None
            if sampled:
                self._check_pass(pre, state, s_hat, captured)
                self.checked_passes += 1
            self.pass_index += 1
            return out
        return pass_fn

    # -- a level's start and end ----------------------------------------------

    def _start_level(self, computer):
        self.level += 1
        self.pass_index = 0
        sc = self.scene
        self.epis = ref.normalize(next(self._inputs))
        self.frames = self.epis.permute(1, 0, 2, 3).contiguous()
        V, S, U, C = self.epis.shape
        self.slope = U / sc.vol.shape[2]
        self.accept_all = (ref.PYRAMID["accept_all_last_scale"]
                           and self.level == self.n_levels - 1)
        ctl = None
        if self.control:
            self.epis_ctl = ref.normalize(next(self._inputs_ctl), BF16)
            ctl = float(torch.max(torch.abs(self.epis_ctl.float()
                                            - self.epis)))
        prog = computer.epis
        err = (float(torch.max(torch.abs(prog - self.epis)))
               if prog.shape == self.epis.shape else float("inf"))
        self._read("level_err", err, ctl)
        self.bounds = None
        if self.level > 0:
            lo = torch.full((S, V, U), ref.f32(sc.dmin), device=prog.device)
            hi = torch.full((S, V, U), ref.f32(sc.dmax), device=prog.device)
            parent = self.finals[-1]
            self.bounds = ref.bounds_from_parent(
                parent["best_depth"], self.valids[-1], lo, hi)
            scale = max(sc.dmax - sc.dmin, 1e-12)
            got = (computer.dmin_s_v_u, computer.dmax_s_v_u)
            err = max(float(torch.max(torch.abs(g - w))) / scale
                      if g.shape == w.shape else float("inf")
                      for g, w in zip(got, self.bounds))
            ctl = None
            if self.control:
                c = ref.bounds_from_parent(parent["best_depth"].to(BF16),
                                           self.valids[-1], lo, hi)
                ctl = max(float(torch.max(torch.abs(x.float() - w))) / scale
                          for x, w in zip(c, self.bounds))
            self._read("bounds_err", err, ctl)

    def _finish_level(self, computer):
        st = computer.state
        final = {n: getattr(st, n) for n in ("ce", "ce_mask", "disp_conf",
                                             "line_conf", "best_depth")}
        self.finals.append(final)
        self.valids.append(ref.validity(final, self.scene.score_version,
                                        self.accept_all))

    def _check_start(self, state):
        ce, mask = ref.edge_confidence(self.epis)
        ce, mask = (x.permute(1, 0, 2).contiguous() for x in (ce, mask))

        def reading(ce_got, mask_got, st=None):
            if ce_got.shape != ce.shape:
                return float("inf")
            top = max(float(torch.max(ce)), 1e-12)
            r = max(float(torch.max(torch.abs(ce_got.float() - ce))) / top,
                    share(mask_got != mask, mask.numel()))
            if st is not None:
                r = max(r, share(st.claim != mask, mask.numel()))
                for n in ("disp_conf", "best_depth", "rbar", "line_conf"):
                    plane = getattr(st, n)
                    r = max(r, share(plane != 0, plane.numel()))
            return r

        ctl = None
        if self.control:
            c, m = ref.edge_confidence(self.epis_ctl)
            ctl = reading(c.permute(1, 0, 2), m.permute(1, 0, 2))
        self._read("edge_err", reading(state.ce, state.ce_mask, state), ctl)

    # -- a sampled pass ----------------------------------------------------

    def _check_pass(self, pre: dict, post, s_hat: int, captured: dict):
        sc = self.scene
        active = pre["ce_mask"][s_hat] & pre["claim"][s_hat]
        res = captured.get("res")
        filtered = captured.get("filtered")
        if res is None or filtered is None:
            for n in ("sweep_gap", "sweep_err", "median_miss", "pass_miss"):
                self._read(n, float("inf"))
            return
        res = {f: getattr(res, f) for f in ("best_score", "score_mean",
                                            "best_depth", "rbar", "k_best")}
        self._check_sweep(active, s_hat, res)

        merged = ref.merge(pre, s_hat, active, res)
        med = ref.selective_median(merged["best_depth"], self.frames[s_hat],
                                   merged["ce_mask"])
        n_mask = int(merged["ce_mask"].sum())
        miss = share(differs(filtered, med) & merged["ce_mask"], n_mask)
        ctl = None
        if self.control:
            m = ref.selective_median(merged["best_depth"], self.frames[s_hat],
                                     merged["ce_mask"], BF16)
            ctl = share(differs(m, med) & merged["ce_mask"], n_mask)
        self._read("median_miss", miss, ctl)

        want = self._ref_pass(pre, s_hat, active, res, filtered, F32)
        changed = sum(int(differs(want[n], pre_plane(pre, n, s_hat)).sum())
                      for n in want)
        got = {n: (getattr(post, n)[s_hat] if n == "rbar"
                   else getattr(post, n)) for n in want}
        miss = sum(int(differs(got[n], want[n]).sum())
                   if got[n].shape == want[n].shape else want[n].numel()
                   for n in want) / max(1, changed)
        ctl = None
        if self.control:
            c = self._ref_pass(pre, s_hat, active, res, filtered, BF16)
            ctl = sum(int(differs(c[n], want[n]).sum())
                      for n in want) / max(1, changed)
        self._read("pass_miss", miss, ctl)

    def _ref_pass(self, pre, s_hat, active, res, filtered, dtype):
        """The state planes after the pass, from its starting state, the
        sweep's results and the filtered depths."""
        merged = ref.merge(pre, s_hat, active, res, dtype)
        claim = pre["claim"].clone()
        claim[s_hat] = active
        out = {}
        for n in ("ce", "ce_mask", "best_depth", "disp_conf"):
            out[n] = pre[n].to(merged[n].dtype).clone()
            out[n][s_hat] = merged[n]
        filt = filtered.to(dtype)
        payloads = [(out["best_depth"], filt),
                    (out["disp_conf"], merged["disp_conf"])]
        sv = self.scene.score_version
        if sv == "line":
            out["line_conf"] = pre["line_conf"].to(dtype).clone()
            lc = torch.where(merged["good"], ref.line_confidence(
                out["ce"], filt, res["k_best"], merged["ce_mask"], s_hat,
                dtype), out["line_conf"][s_hat])
            out["line_conf"][s_hat] = lc
            source = lc > ref.PARAMS["line_score_threshold"]
            payloads.append((out["line_conf"], lc))
        elif sv == "disp":
            source = merged["disp_conf"] > ref.PARAMS["disp_score_threshold"]
        else:
            source = merged["ce_mask"]
        out["claim"], painted = ref.paint(claim, self.frames, filt,
                                          merged["rbar"], source, s_hat,
                                          self.slope, payloads, dtype)
        for n, t in zip(("best_depth", "disp_conf", "line_conf"), painted):
            out[n] = t
        out["rbar"] = merged["rbar"]
        return out

    def sweep_route(self) -> str:
        """The route of this level's sweeps (see the module's docstring):
        ``"pixel"`` (each pixel's own grid and positions), ``"row"`` or
        ``"tile"``."""
        sc = self.scene
        if ((sc.vol.shape[-1] in PIXEL_KERNEL_C
             and sc.D <= PIXEL_KERNEL_MAX_D)
                or sc.interpolation == "nearest"):
            return "pixel"
        return "row" if self.bounds is None else "tile"

    def _check_sweep(self, active, s_hat, res):
        sc = self.scene
        V, U = active.shape
        px = torch.nonzero(active.reshape(-1)).reshape(-1)
        if px.numel() == 0:
            return
        if px.numel() > SWEEP_PIXELS:
            pick = self.rng.choice(px.numel(), SWEEP_PIXELS, replace=False)
            px = px[torch.as_tensor(np.sort(pick), device=px.device)]
        v, u = px // U, px % U
        if self.bounds is None:
            lo = torch.full(px.shape, ref.f32(sc.dmin), device=px.device)
            hi = torch.full(px.shape, ref.f32(sc.dmax), device=px.device)
        else:
            lo = self.bounds[0][s_hat].reshape(-1)[px]
            hi = self.bounds[1][s_hat].reshape(-1)[px]
        line = sc.score_version == "line"
        route = self.sweep_route()
        kw = dict(D=sc.D, s_hat=s_hat, slope=self.slope, steps=sc.steps,
                  interpolation=sc.interpolation, with_k=line)
        if route == "row":
            kw.update(rule="row", steps=counts.MEAN_SHIFT_STEPS)
        elif route == "tile":
            glo, ghi = ref.tile_grid(active, self.bounds[0][s_hat],
                                     self.bounds[1][s_hat],
                                     (sc.dmin, sc.dmax))
            kw.update(plo=lo, phi=hi, steps=counts.MEAN_SHIFT_STEPS)
            lo, hi = glo.reshape(-1)[px], ghi.reshape(-1)[px]
        want = ref.sweep_pixels(self.epis, v, u, lo, hi, **kw)
        got = {"best_depth": res["best_depth"][v, u],
               "best_score": res["best_score"][v, u],
               "score_mean": res["score_mean"][v, u],
               "rbar": res["rbar"][v, u]}
        if line:
            got["k_best"] = res["k_best"][v, :, u]
        gap, err = sweep_readings(got, want, sc.D)
        cgap = cerr = None
        if self.control:
            c = ref.sweep_pixels(self.epis_ctl, v, u, lo, hi, dtype=BF16,
                                 **kw)
            best = torch.argmax(competing(c), dim=1)
            take = torch.arange(best.numel(), device=best.device)
            cgot = {"best_depth": c["cand"][take, best],
                    "best_score": c["score"][take, best],
                    "score_mean": c["mean"], "rbar": c["rbar"][take, best]}
            if line:
                cgot["k_best"] = c["k"][take, best]
            cgap, cerr = sweep_readings(cgot, want, sc.D)
        self._read("sweep_gap", gap, cgap)
        self._read("sweep_err", err, cerr)

    # -- the scene's end ---------------------------------------------------

    def finish(self, fused: torch.Tensor, valid: torch.Tensor):
        """The fusion of the replayed levels against the timed scene's
        fused map and validity."""
        if len(self.finals) != self.n_levels:
            self._read("fusion_err", float("inf"))
            return
        want, want_valid = ref.fuse([f["best_depth"] for f in self.finals],
                                    self.valids)

        def reading(f, m):
            if f.shape != want.shape:
                return float("inf")
            return max(share(differs(f, want), want.numel()),
                       share(m != want_valid, want.numel()))

        ctl = None
        if self.control:
            ctl = reading(*ref.fuse([f["best_depth"] for f in self.finals],
                                    self.valids, BF16))
        self._read("fusion_err", reading(fused, valid), ctl)


def pre_plane(pre: dict, name: str, s_hat: int) -> torch.Tensor:
    return pre[name][s_hat] if name == "rbar" else pre[name]


def competing(res: dict) -> torch.Tensor:
    """A sweep's scores ``[P, D]``, -inf at the candidates that may not win
    (outside a pixel's allowed range in tile mode)."""
    if res.get("allowed") is None:
        return res["score"]
    return torch.where(res["allowed"], res["score"],
                       torch.full_like(res["score"], float("-inf")))


def sweep_readings(got: dict, want: dict, D: int):
    """(gap, err) of one sweep's picks at sampled pixels against the
    reference's curves: how far below the reference's best score the
    reference's score at the program's pick lies, and how far the
    program's score, mean score, r_bar, depth (in grid steps) and k_best
    lie from the reference's at that pick.  In tile mode only the allowed
    candidates compete: a pick outside them reads inf."""
    cand = want["cand"]
    idx = torch.argmin(torch.abs(cand - got["best_depth"][:, None]), dim=1)
    take = torch.arange(idx.numel(), device=idx.device)
    score = competing(want)
    gap = float(torch.max(score.max(dim=1).values - score[take, idx]))
    step = torch.abs(cand[:, -1] - cand[:, 0]) / max(D - 1, 1)
    step = torch.where(step > 0, step, torch.ones_like(step))
    terms = [torch.abs(got["best_depth"] - cand[take, idx]) / step,
             torch.abs(got["best_score"] - score[take, idx]),
             torch.abs(got["score_mean"] - want["mean"]),
             torch.abs(got["rbar"] - want["rbar"][take, idx]).amax(dim=1)]
    if "k_best" in got:
        terms.append(torch.abs(got["k_best"] - want["k"][take, idx])
                     .amax(dim=1))
    err = max(float(torch.nan_to_num(t, nan=float("inf")).max())
              for t in terms)
    return gap, err


def run_check(scene: Scene, run_scene: Callable, passes: List[int],
              seed: int, fused: torch.Tensor, valid: torch.Tensor,
              control: bool = False, patches: Optional[Patches] = None
              ) -> Check:
    """Replay the scene under the check's hooks and compare.
    ``run_scene()`` runs the program's pipeline and returns (fused,
    validity, passes); ``patches`` may carry further wrappers (the
    counters of a traced run)."""
    chk = Check(scene, passes, seed, control)
    with patches or Patches() as p:
        if not chk.install(p):
            chk._read("pass_miss", float("inf"))
            return chk
        out = run_scene()
        del out
    chk.finish(fused, valid)
    return chk
