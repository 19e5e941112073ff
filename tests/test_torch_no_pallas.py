"""``use_pallas=False`` / ``--no-pallas`` in the port: the JAX package's
XLA path (the plain sweep on each pixel's own grid, the plain median and
paint), on the computer's device.  At C=4 on a bounds-edited level the
kernel route takes the tile sweep's quantised grids, so only the XLA
semantics match the JAX package's ``use_pallas=False`` there (claims and
masks exact, depth within 1e-4, disp_conf within 2e-3: the tolerances of
tests/test_torch_depth2d.py).  The CLI takes ``--no-pallas`` and
``--sharded``."""

import jax.numpy as jnp
import numpy as np
import torch

import oracle
from remotesensingproject_tpu.models import depth2d as jd
from remotesensingproject_tpu.models.pile import (
    Depth1DComputerPile as JPile)
from remotesensingproject_tpu_torch.cli import main as cli
from remotesensingproject_tpu_torch.models.depth2d import Depth2DComputer
from remotesensingproject_tpu_torch.models.fine_to_coarse import FineToCoarse
from remotesensingproject_tpu_torch.models.pile import Depth1DComputerPile
from remotesensingproject_tpu_torch.utils.io import (build_epis_from_imgs,
                                                     read_imgs_from_folder)

DMIN, DMAX = -1.0, 1.5
GAINS = np.array([1.0, 0.8, 0.6, 0.9], np.float32)


def _four_bands(S=8, V=6, U=160, seed=5):
    vol, _ = oracle.make_synthetic_lf(S=S, V=V, U=U, C=1, seed=seed,
                                      dmin=DMIN, dmax=DMAX)
    return np.ascontiguousarray(vol * GAINS)


def _edited(S, V, U, seed=7):
    rng = np.random.default_rng(seed)
    center = rng.uniform(DMIN, DMAX, (V, U)).astype(np.float32)
    lo = np.clip(center - 0.3, DMIN, DMAX)
    hi = np.clip(center + 0.3, DMIN, DMAX)
    return tuple(np.ascontiguousarray(np.broadcast_to(b, (S, V, U)))
                 for b in (lo, hi))


def test_no_pallas_is_the_xla_path_at_c4_on_an_edited_level():
    vol = _four_bands()
    lo, hi = _edited(8, 6, 160)
    jc = jd.Depth2DComputer(jnp.asarray(vol), DMIN, DMAX, 7,
                            use_pallas=False)
    jc.set_bounds(jnp.asarray(lo), jnp.asarray(hi))
    ref = jc.run()
    runs = {}
    for pallas in (False, None):
        tc = Depth2DComputer(vol, DMIN, DMAX, 7, device="cpu",
                             use_pallas=pallas)
        tc.set_bounds(torch.from_numpy(lo), torch.from_numpy(hi))
        runs[pallas] = tc.run()
    got = runs[False]
    for name in ("claim", "ce_mask"):
        np.testing.assert_array_equal(getattr(got, name).numpy(),
                                      np.asarray(getattr(ref, name)), name)
    for name, atol in (("best_depth", 1e-4), ("disp_conf", 2e-3),
                       ("ce", 1e-6)):
        np.testing.assert_allclose(getattr(got, name).numpy(),
                                   np.asarray(getattr(ref, name)), rtol=0,
                                   atol=atol, err_msg=name)
    # the kernel route (the tile sweep's quantised grids) is another one
    assert not torch.equal(runs[None].best_depth, got.best_depth)


def test_pile_no_pallas_is_the_xla_path():
    vol = _four_bands(S=8, V=6, U=64)
    jp = JPile(jnp.asarray(vol), DMIN, DMAX, 7, use_pallas=False).run()
    got = Depth1DComputerPile(vol, DMIN, DMAX, 7, device="cpu",
                              use_pallas=False).run()
    np.testing.assert_array_equal(got.edge_mask.numpy(),
                                  np.asarray(jp.edge_mask))
    np.testing.assert_allclose(got.best_depth.numpy(),
                               np.asarray(jp.best_depth), rtol=0, atol=1e-4)
    kernels = Depth1DComputerPile(vol, DMIN, DMAX, 7, device="cpu").run()
    assert not torch.equal(kernels.rbar, got.rbar)  # the row rule


def _frames(tmp_path):
    from PIL import Image

    vol, _ = oracle.make_synthetic_lf(S=4, V=12, U=24, C=1, seed=2)
    folder = tmp_path / "frames"
    folder.mkdir()
    u8 = np.clip(vol * 255.0, 0, 255).astype(np.uint8)
    for s in range(u8.shape[1]):
        Image.fromarray(u8[:, s, :, 0]).save(folder / f"frame_{s:03d}.png")
    return str(folder), build_epis_from_imgs(read_imgs_from_folder(
        str(folder), "png"))


def _cli(command, folder, out, *flags):
    cli.main([command, folder, "--ext", "png", "--dmin", "-1", "--dmax",
              "1.5", "--dim-d", "5", "--out", str(out), "--device", "cpu",
              *flags])
    return np.load(out / f"{command.replace('-', '_')}_results.npz")


def test_cli_no_pallas(tmp_path):
    folder, epis = _frames(tmp_path)
    got = _cli("depth2d", folder, tmp_path / "d2", "--no-pallas")
    c = Depth2DComputer(epis, DMIN, DMAX, 5, device="cpu", use_pallas=False)
    st = c.run()
    np.testing.assert_array_equal(got["best_depth"], st.best_depth.numpy())
    np.testing.assert_array_equal(
        got["validity"], c.get_valid_depths_mask_s_v_u().numpy())
    got = _cli("pile", folder, tmp_path / "p", "--no-pallas")
    want = Depth1DComputerPile(epis, DMIN, DMAX, 5, device="cpu",
                               use_pallas=False).run()
    np.testing.assert_array_equal(got["best_depth"],
                                  want.best_depth.numpy())


def test_cli_sharded_fine_to_coarse(tmp_path):
    """``--sharded`` without torchrun and with ``--device cpu``: one rank
    over gloo; rank 0 writes the single-device results."""
    folder, epis = _frames(tmp_path)
    got = _cli("fine-to-coarse", folder, tmp_path / "f", "--sharded",
               "--no-pallas")
    f = FineToCoarse(epis, DMIN, DMAX, 5, device="cpu", use_pallas=False)
    f.run()
    fused, valid = f.get_results()
    np.testing.assert_array_equal(got["fused"], fused.numpy())
    np.testing.assert_array_equal(got["validity"], valid.numpy())
    assert (tmp_path / "f" / "depth_map_000.png").exists()
