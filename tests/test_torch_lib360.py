"""PyTorch port, lib360's geometry conversion and 360 metrics (ROADMAP
queue 1 item 11g), against the JAX package, mirroring tests/test_lib360.py
at small sizes.

  maps       every geometry's dirs/coords pair (GEOMETRIES) equals the JAX
             package's (both numpy float64 on the host), and so do the
             conversion map, the Lanczos tables, the Fibonacci sphere and
             the metrics' sample maps;
  resample   geo_convert (ERP -> CMP, EAC, SSP, fisheye; CMP -> ERP) and
             render_viewport with nn, bilinear, lanczos2 and lanczos3 on
             smooth and random planes: the samples that differ from the
             JAX package's are pinned, 0 for every method (the Lanczos
             sums take XLA's chain of FMAs);
  metrics    WS-PSNR, S-PSNR-NN, S-PSNR-I, CPP-PSNR, viewport PSNR and
             metrics_360 within 1e-3 dB of the JAX package's (float32 sums
             in another order), MS-SSIM within 1e-12 (float64 on the host
             in both);
  behaviour  tests/test_lib360.py's properties on the port: identical
             planes score high, equator noise hurts WS-PSNR more than pole
             noise, the ERP -> CMP -> ERP round trip, EAC differs from CMP,
             each added geometry's coords invert its dirs.

Cost on one core: about 15 s (the JAX resampling jits' compiles)."""
import numpy as np
import pytest
import torch

from vvc_mm_tpu.lib360 import geometry as jg
from vvc_mm_tpu.lib360 import metrics as jm
from vvc_mm_tpu_torch.lib360 import geometry as pg
from vvc_mm_tpu_torch.lib360 import metrics as pm

torch.set_num_threads(1)

CPU = "cpu"
# geometry -> (width, height) of its packing at a small size
SIZES = {"erp": (64, 32), "hcmp": (96, 64), "cmp": (96, 64),
         "eac": (96, 64), "acp": (96, 64), "eap": (64, 32),
         "aep": (64, 32), "cpp": (64, 32), "ssp": (96, 64),
         "ecp": (96, 64), "rsp": (96, 64), "hec": (64, 32),
         "gcmp": (96, 64), "ohp": (64, 16), "isp": (80, 32),
         "tsp": (64, 32), "fisheye": (32, 32)}
H, W = 64, 128
# (source, destination, its size, method) -> samples that differ from the
# JAX package's, on the smooth plane and on the random plane (seed 1234);
# measured on the development machine's CPU, no slack
RESAMPLE = {
    ("erp", "cmp", (64, 96), "nn"): (0, 0),
    ("erp", "cmp", (64, 96), "bilinear"): (0, 0),
    ("erp", "cmp", (64, 96), "lanczos2"): (0, 0),
    ("erp", "cmp", (64, 96), "lanczos3"): (0, 0),
    ("erp", "eac", (64, 96), "bilinear"): (0, 0),
    ("erp", "eac", (64, 96), "lanczos3"): (0, 0),
    ("erp", "ssp", (64, 96), "lanczos3"): (0, 0),
    ("erp", "fisheye", (64, 64), "nn"): (0, 0),
    ("erp", "fisheye", (64, 64), "bilinear"): (0, 0),
    ("erp", "fisheye", (64, 64), "lanczos3"): (0, 0),
    ("cmp", "erp", (64, 128), "lanczos2"): (0, 0),
}


@pytest.fixture(scope="module")
def planes():
    rng = np.random.default_rng(1234)
    yy, xx = np.mgrid[0:H, 0:W]
    smooth = (128 + 80 * np.sin(xx / 9.0) * np.cos(yy / 7.0)).astype(
        np.int32)
    noisy = rng.integers(0, 256, size=(H, W)).astype(np.int32)
    return smooth, noisy


@pytest.mark.parametrize("name", list(SIZES))
def test_geometry_maps_match_jax(name):
    assert set(pg.GEOMETRIES) == set(jg.GEOMETRIES) == set(SIZES)
    w, h = SIZES[name]
    dj = jg.GEOMETRIES[name][0](w, h)
    dp = pg.GEOMETRIES[name][0](w, h)
    np.testing.assert_array_equal(dp, dj)
    for sw, sh in ((w, h), (128, 64)):
        np.testing.assert_array_equal(pg.GEOMETRIES[name][1](dp, sw, sh),
                                      jg.GEOMETRIES[name][1](dj, sw, sh))


def test_host_tables_match_jax():
    np.testing.assert_array_equal(pg._conversion_map("erp", W, H, "cmp",
                                                     96, 64),
                                  jg._conversion_map("erp", W, H, "cmp",
                                                     96, 64))
    for a in (2, 3):
        np.testing.assert_array_equal(pg._lanczos_lut(a), jg._lanczos_lut(a))
    np.testing.assert_array_equal(pm.fibonacci_sphere(4096),
                                  jm.fibonacci_sphere(4096))
    np.testing.assert_array_equal(pm._sphere_to_erp_nn(4096, W, H),
                                  jm._sphere_to_erp_nn(4096, W, H))
    for a, b in zip(pm._cpp_map(W, H), jm._cpp_map(W, H)):
        np.testing.assert_array_equal(a, b)
    for a, b in zip(pm._sphere_to_erp_bilin(4096, W, H),
                    jm._sphere_to_erp_bilin(4096, W, H)):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(pm._ws_weights(H), jm._ws_weights(H))


@pytest.mark.parametrize("case", list(RESAMPLE),
                         ids=["-".join(map(str, c[:2])) + f"-{c[3]}"
                              for c in RESAMPLE])
def test_geo_convert_matches_jax(planes, case):
    src, dst, size, method = case
    for plane, pinned in zip(planes, RESAMPLE[case]):
        if src != "erp":
            plane = jg.geo_convert(plane, "erp", src, (64, 96), "bilinear")
        want = jg.geo_convert(plane, src, dst, size, method)
        got = pg.geo_convert(plane, src, dst, size, method, device=CPU)
        assert got.shape == want.shape == size
        assert got.dtype == want.dtype
        assert int((got != want).sum()) == pinned
        assert np.abs(got.astype(np.int64) - want).max() <= 1


@pytest.mark.parametrize("method", ["nn", "bilinear", "lanczos3"])
def test_render_viewport_matches_jax(planes, method):
    for plane in planes:
        for yaw, pitch in ((45.0, 10.0), (-90.0, 0.0), (170.0, -60.0)):
            want = jg.render_viewport(plane, 32, 24, 90, yaw, pitch, method)
            got = pg.render_viewport(plane, 32, 24, 90, yaw, pitch, method,
                                     device=CPU)
            assert got.shape == (24, 32)
            np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("noise", [2, 6])
def test_metrics_match_jax(planes, noise):
    rng = np.random.default_rng(noise)
    for p in planes:
        q = np.clip(p + rng.integers(-noise, noise + 1, size=p.shape), 0,
                    255).astype(np.int32)
        for name in ("ws_psnr", "s_psnr_nn", "cpp_psnr", "s_psnr_i"):
            want = float(getattr(jm, name)(p, q))
            got = getattr(pm, name)(p, q, device=CPU)
            assert abs(got - want) <= 1e-3, name
        assert abs(pm.viewport_psnr(p, q, device=CPU)
                   - jm.viewport_psnr(p, q)) <= 1e-3
        mj = jm.metrics_360(p, q, viewport=True)
        mp = pm.metrics_360(p, q, viewport=True, device=CPU)
        assert set(mp) == set(mj)
        for k in mj:
            assert abs(mp[k] - float(mj[k])) <= 1e-3, k
        assert abs(pm.ms_ssim(p, q) - jm.ms_ssim(p, q)) <= 1e-12
    # 10-bit
    p10 = planes[1] * 4
    q10 = p10 + 3
    assert abs(pm.ws_psnr(p10, q10, 10, device=CPU)
               - float(jm.ws_psnr(p10, q10, 10))) <= 1e-3
    assert abs(pm.ms_ssim(p10, q10, 10) - jm.ms_ssim(p10, q10, 10)) <= 1e-12


def test_lib360_properties(planes):
    """tests/test_lib360.py's checks on the port."""
    smooth, noisy = planes
    assert pm.ws_psnr(noisy, noisy, device=CPU) > 90
    eq = noisy.copy()
    eq[30:34] = np.clip(eq[30:34] + 8, 0, 255)
    po = noisy.copy()
    po[0:4] = np.clip(po[0:4] + 8, 0, 255)
    assert pm.ws_psnr(noisy, eq, device=CPU) < pm.ws_psnr(noisy, po,
                                                          device=CPU)
    cmp_img = pg.geo_convert(smooth, "erp", "cmp", (64, 96), "lanczos2",
                             device=CPU)
    back = pg.geo_convert(cmp_img, "cmp", "erp", (H, W), "lanczos2",
                          device=CPU)
    assert np.abs(back[8:-8].astype(np.int64) - smooth[8:-8]).mean() < 6.0
    a = pg.geo_convert(noisy, "erp", "cmp", (64, 96), "bilinear", device=CPU)
    b = pg.geo_convert(noisy, "erp", "eac", (64, 96), "bilinear", device=CPU)
    assert not np.array_equal(a, b)
    n = np.linalg.norm(pg.cmp_dirs(96, 64), axis=-1)
    assert np.allclose(n, 1.0, atol=1e-6)
    for name, (w, h) in {"eap": (64, 32), "fisheye": (32, 32),
                         "acp": (48, 32), "eac": (48, 32)}.items():
        dirs_fn, coords_fn = pg.GEOMETRIES[name]
        xy = coords_fn(dirs_fn(w, h), w, h)
        xx, yy = np.meshgrid(np.arange(w), np.arange(h))
        m = np.ones((h, w), bool)
        if name == "fisheye":       # only the image circle is active
            u = 2.0 * (xx + 0.5) / w - 1.0
            v = 2.0 * (yy + 0.5) / h - 1.0
            m = u * u + v * v < 0.98
        assert np.abs(np.stack([xx, yy], -1) - xy)[m].max() < 0.51, name
    with pytest.raises(ValueError):
        pg.geo_convert(noisy, "erp", "cmp", (64, 96), "bicubic", device=CPU)
