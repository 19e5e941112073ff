"""The kernels' launch path, ``ops.cuda_build.Entry``, on the CPU: a fake
library stands in for a built one.  Also holds every declared entry's
signature against its C prototype in ``csrc/``."""

import collections
import importlib
import re
import types

import pytest
import torch

from remotesensingproject_tpu_torch.ops import cuda_build

STREAM = 0xC0FFEE


class _FakeFn:
    """A C function of the fake library: records its calls and returns
    ``code``."""

    def __init__(self, code=0):
        self.code, self.calls = code, []
        self.argtypes = self.restype = None

    def __call__(self, *args):
        self.calls.append(args)
        return self.code


def _fake_lib(code=0):
    def error_string(err):
        return f"fake error {err}".encode()

    error_string.restype = None
    return types.SimpleNamespace(rslf_fake_run=_FakeFn(code),
                                 rslf_fake_plan=_FakeFn(code),
                                 rslf_fake_error_string=error_string)


@pytest.fixture
def fake(monkeypatch):
    """The library ``fake``, loaded through a counting ``cuda_build.load``,
    with clean bindings and counts and a current stream of ``STREAM``."""
    lib = _fake_lib()
    loads = []

    def load(name):
        assert name == "fake"
        loads.append(name)
        return lib

    monkeypatch.setattr(cuda_build, "load", load)
    monkeypatch.setattr(cuda_build, "_bound", {})
    monkeypatch.setattr(cuda_build, "_libs", {})
    monkeypatch.setattr(cuda_build, "launches", collections.Counter())
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda device: types.SimpleNamespace(
                            cuda_stream=STREAM))
    return lib, loads


@pytest.mark.parametrize("code,no_fit,raises", [
    (0, None, None), (0, "S=5", None), (700, None, RuntimeError),
    (700, "S=5", RuntimeError), (9, None, RuntimeError),
    (9, "S=5", NotImplementedError)])
def test_launch_marshals_raises_and_counts(fake, code, no_fit, raises):
    """Tensors pass as their pointers and None as NULL, the stream comes
    last; a nonzero code raises with the library's error string (code 9
    with ``no_fit``: NotImplementedError) and counts no launch."""
    lib, loads = fake
    lib.rslf_fake_run.code = code
    run = cuda_build.Entry("fake", "rslf_fake_run", "pp i f p s")
    a = torch.zeros(4)
    b = torch.ones(3, dtype=torch.int32)
    if raises is None:
        run(a, None, 7, 0.5, b, device=torch.device("cuda:0"), no_fit=no_fit)
        assert cuda_build.launches["fake"] == 1
    else:
        match = {RuntimeError: f"rslf_fake_run.*fake error {code}",
                 NotImplementedError: "S=5.*shared memory"}[raises]
        with pytest.raises(raises, match=match):
            run(a, None, 7, 0.5, b, device=torch.device("cuda:0"),
                no_fit=no_fit)
        assert cuda_build.launches["fake"] == 0
    assert lib.rslf_fake_run.calls == [(a.data_ptr(), None, 7, 0.5,
                                        b.data_ptr(), STREAM)]
    P, I, F = cuda_build.ctypes.c_void_p, cuda_build.ctypes.c_int, \
        cuda_build.ctypes.c_float
    assert lib.rslf_fake_run.argtypes == [P, P, I, F, P, P]
    assert lib.rslf_fake_run.restype is cuda_build.ctypes.c_int


@pytest.mark.parametrize("case", ["plan", "rebind"])
def test_plan_query_and_binding(fake, monkeypatch, case):
    """A host query takes no stream and counts nothing; a function is bound
    once, and bound again after ``set_build_dir`` or ``use_library``."""
    lib, loads = fake
    plan = cuda_build.Entry("fake", "rslf_fake_plan", "ii p")
    if case == "plan":
        got = cuda_build.read_plan(plan, 3, 1, size="S=3")
        assert got == dict(threads=0, window_items=0, smem_bytes=0,
                           blocks_per_sm=0, sms=0, resident_warps=0)
        assert len(lib.rslf_fake_plan.calls) == 1
        assert lib.rslf_fake_plan.calls[0][:2] == (3, 1)
        assert not cuda_build.launches
        return
    run = cuda_build.Entry("fake", "rslf_fake_run", "p s")
    dev = torch.device("cuda:0")
    run(None, device=dev)
    run(None, device=dev)
    plan(1, 2, None)
    assert loads == ["fake", "fake"]          # one a function
    assert cuda_build.launches == {"fake": 2}
    monkeypatch.setattr(cuda_build, "BUILD_DIR", cuda_build.BUILD_DIR)
    cuda_build.set_build_dir(cuda_build.BUILD_DIR)
    run(None, device=dev)
    assert loads == ["fake"] * 3
    other = _fake_lib()
    monkeypatch.setattr(cuda_build.ctypes, "CDLL", lambda path: other)
    monkeypatch.setattr(cuda_build, "load",
                        lambda name: cuda_build._libs[name])
    cuda_build.use_library("fake", "elsewhere.so")
    run(None, device=dev)
    assert other.rslf_fake_run.calls == [(None, STREAM)]
    assert cuda_build.launches == {"fake": 4}


def test_kernels_are_the_sources():
    assert cuda_build.KERNELS == tuple(sorted(
        p.stem for p in cuda_build.CSRC_DIR.glob("*.cu")))


WRAPPERS = ("sweep_pallas", "sweep_pallas_pixel", "sweep_pallas_perpixel",
            "median_pallas", "propagation_pallas", "line_confidence", "merge")


def _entries():
    out = []
    for name in WRAPPERS:
        mod = importlib.import_module(
            f"remotesensingproject_tpu_torch.ops.{name}")
        out += [e for e in vars(mod).values()
                if isinstance(e, cuda_build.Entry)]
    return out


def _prototype(lib: str, symbol: str) -> str:
    """The argument letters of ``symbol``'s C prototype in its ``.cu``."""
    src = (cuda_build.CSRC_DIR / f"{lib}.cu").read_text()
    m = re.search(rf"RSLF_EXPORT int {symbol}\(([^)]*)\)", src)
    assert m, f"{symbol} is not exported by {lib}.cu"
    letters = []
    for arg in (a.strip() for a in m.group(1).split(",")):
        if arg == "void* stream":
            letters.append("s")
        elif "*" in arg:
            letters.append("p")
        else:
            letters.append({"int": "i", "float": "f"}[arg.rsplit(" ", 1)[0]])
    return "".join(letters)


@pytest.mark.parametrize("entry", _entries(), ids=lambda e: e.symbol)
def test_entry_matches_its_c_prototype(entry):
    """Each declared entry spells its C function's arguments: a drift
    here would pass wrong values to a kernel on the card."""
    assert entry.lib in cuda_build.KERNELS
    assert entry.signature == _prototype(entry.lib, entry.symbol)


def test_every_library_has_a_launch():
    assert {e.lib for e in _entries() if e.launch} == set(cuda_build.KERNELS)
