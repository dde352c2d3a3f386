"""docs/API.md contract test: every call the API reference shows must keep
working exactly as written (same constructors, same keyword names), so the
documentation cannot rot against the library."""

import numpy as np

from tpurt import (
    CameraController,
    Light,
    Material,
    MeshData,
    RenderConfig,
    Sphere,
    build_scene,
    init_state,
    load_checkpoint,
    make_camera,
    render,
    render_step,
    resolve_image,
    save_checkpoint,
    set_vfov,
)


def test_pfm_io(tmp_path):
    """PFM writer/reader contracts: exact roundtrip, spec |scale| applied
    on read, non-RGB shapes rejected on write."""
    import pytest
    from tpurt.utils.image import read_pfm, write_pfm
    a = np.random.default_rng(1).random((8, 4, 3)).astype(np.float32)
    p = str(tmp_path / "a.pfm")
    write_pfm(p, a)
    np.testing.assert_array_equal(read_pfm(p), a)
    gray = a[..., 0]
    write_pfm(p, gray)  # (H, W) broadcasts to 3 channels
    np.testing.assert_array_equal(read_pfm(p), np.repeat(gray[..., None], 3, 2))
    with open(p, "wb") as f:  # external file with a non-unit scale
        f.write(b"PF\n4 8\n-0.25\n")
        f.write(np.ascontiguousarray(a[::-1]).astype("<f4").tobytes())
    np.testing.assert_allclose(read_pfm(p), a * np.float32(0.25), rtol=1e-7)
    with pytest.raises(ValueError):
        write_pfm(p, np.zeros((4, 4, 4), np.float32))


def test_api_md_snippets(tmp_path):
    mesh = MeshData(material_id=0, translation=(0, 0, 4), scale=2.0)
    assert hasattr(mesh, "load_obj")

    scene = build_scene(
        materials=[Material.diffuse((0.7, 0.7, 0.7)),
                   Material.dielectric(ior=1.5, roughness=0.01),
                   Material.metal((1.0, 0.76, 0.33))],
        spheres=[Sphere(material_id=1, scale=1.0, translation=(0, 1, 0))],
        lights=[Light.square_area(center=(0, 10, 0), normal=(0, -1, 0),
                                  half_width=3.0, color=(1, 1, 1),
                                  intensity=5.0, color_temp=5500.0)])

    cam = make_camera((0, 5, -12), (0, 5, 0), vfov=60.0, aspect_ratio=16 / 9)
    cam = set_vfov(cam, 45.0, 16 / 9)
    ctl = CameraController()
    ctl.set_key("forward", True)
    ctl.mouse_move(1.0, 2.0)
    cam2, changed = ctl.update(cam, 1e5)
    assert changed

    from tpurt import cornell_spheres_scene
    lit_scene = cornell_spheres_scene()   # walls: guarantees nonzero pixels
    cfg = RenderConfig(width=32, height=16, depth=2, backend="xla",
                       tile_size=512)
    st = init_state(cfg)
    st = render(lit_scene, cfg, cam, st, 1, 2)
    st = render_step(lit_scene, cfg, cam, st, 1)
    st = render_step(lit_scene, cfg, cam, st, 1, depth=1)
    img = resolve_image(cfg, st)
    img2 = resolve_image(cfg, st, key=0.5, saturation=1.2)
    assert img.shape == (16, 32, 3)
    assert not np.allclose(np.asarray(img), np.asarray(img2))

    from tpurt.utils.image import write_png, write_ppm
    write_png(str(tmp_path / "a.png"), np.asarray(img))
    write_ppm(str(tmp_path / "a.ppm"), np.asarray(img))

    # HDR export section: untonemapped radiance + lossless PFM roundtrip.
    # tonemap(resolve_radiance) matches resolve_image to float ulp; the
    # comparison excludes pixels near the Reinhard pole c*key = -1 (only
    # reachable through negative out-of-gamut radiance at very low spp),
    # where ulp-level cross-jit wobble amplifies without bound.
    from tpurt import resolve_radiance, tonemap as _tmod
    from tpurt.utils.image import read_pfm, write_pfm
    hdr = np.asarray(resolve_radiance(cfg, st))
    assert hdr.shape == (16, 32, 3) and hdr.max() > 1e-6
    tm_img = np.asarray(_tmod.tonemap(hdr, cfg.tonemap_key,
                                      cfg.tonemap_saturation))
    safe = np.all(1.0 + hdr * cfg.tonemap_key > 0.25, axis=-1)
    assert safe.mean() > 0.5  # non-vacuous (76% safe at this 2-spp probe)
    np.testing.assert_allclose(tm_img[safe], np.asarray(img)[safe],
                               atol=1e-5, rtol=1e-5)
    write_pfm(str(tmp_path / "a.pfm"), hdr)
    np.testing.assert_array_equal(read_pfm(str(tmp_path / "a.pfm")), hdr)

    save_checkpoint(str(tmp_path / "ck"), cfg, st)
    cfg2, st2 = load_checkpoint(str(tmp_path / "ck"))
    assert cfg2 == cfg
    np.testing.assert_array_equal(np.asarray(st2.rgb_sum),
                                  np.asarray(st.rgb_sum))

    # adaptive sampling section (wavefront path: needs photons off)
    from tpurt import render_adaptive, wavefront_render_budget
    acfg = RenderConfig(width=32, height=16, depth=2, backend="xla",
                        tile_size=512, enable_photons=False, wf_pool=256)
    ast, budgets = render_adaptive(lit_scene, acfg, cam, base_seed=1,
                                   spp=3, pilot_spp=2)
    ast = wavefront_render_budget(lit_scene, acfg, cam, ast, 1,
                                  budgets, max_budget=16)
    assert np.isfinite(np.asarray(resolve_image(acfg, ast))).all()

    # depth-of-field section
    dcfg = RenderConfig(width=32, height=16, depth=2, backend="xla",
                        tile_size=512, aperture=0.3, focus_dist=12.0)
    dst = render(lit_scene, dcfg, cam, init_state(dcfg), 1, 2)
    assert float(dst.rays) > 0

    # denoising section
    from tpurt import denoise_image, render_aovs, atrous_denoise
    dimg = denoise_image(lit_scene, cfg, cam, st)
    aovs = render_aovs(lit_scene, cfg, cam)
    dimg2 = denoise_image(lit_scene, cfg, cam, st, aovs=aovs,
                          iterations=5, sigma_normal=0.35)
    assert np.isfinite(np.asarray(dimg)).all()
    assert (np.asarray(dimg) == np.asarray(dimg2)).all()

    # motion blur section
    from tpurt.camera import MotionCamera
    mcfg = RenderConfig(width=32, height=16, depth=2, backend="xla",
                        tile_size=512, motion_blur=True)
    mcam = MotionCamera(cam0=make_camera((0, 5, -12), (0, 5, 0), vfov=60.0),
                        cam1=make_camera((1, 5, -12), (1, 5, 0), vfov=60.0))
    mst = render(lit_scene, mcfg, mcam, init_state(mcfg), 1, 2)
    assert float(mst.rays) > 0

    # temporal reprojection section
    from tpurt import tonemap as _tm
    from tpurt.temporal import temporal_blend
    lin = denoise_image(lit_scene, cfg, cam, st, aovs=aovs, tonemap=False)
    lin, ts = temporal_blend(None, cam, aovs, lin, alpha=0.8)
    lin, ts = temporal_blend(ts, cam, aovs, lin, alpha=0.8)
    timg = _tm.tonemap(lin, cfg.tonemap_key, cfg.tonemap_saturation)
    assert np.isfinite(np.asarray(timg)).all()

    # rendering conveniences (preset / render_until)
    from tpurt import render_until
    qcfg = RenderConfig.preset("quality", width=32, height=16, depth=2,
                               backend="xla")
    assert qcfg.hero_wavelengths == 4 and qcfg.qmc
    ust, uinfo = render_until(lit_scene, cfg, cam, init_state(cfg), 3,
                              target_rel_err=1e9, batch_spp=2, max_spp=8)
    assert uinfo["converged"] and float(ust.iteration) == uinfo["spp"]

    # ray-query section
    from tpurt import occlusion, trace_rays
    origins = np.zeros((4, 3), np.float32)
    directions = np.tile(np.array([[0, 0, 1]], np.float32), (4, 1))
    hits = trace_rays(lit_scene, origins, directions)
    assert hits.hit.shape == (4,) and hits.position.shape == (4, 3)
    vis = occlusion(lit_scene, origins, directions, t_max=10.0)
    assert vis.shape == (4,) and float(vis.min()) >= 0.0

    from tpurt.utils.scene_io import load_scene_json
    s3, cam_meta = load_scene_json("examples/cornell.json")
    assert cam_meta is not None and "eye" in cam_meta

    from tpurt.parallel import sharding as sh
    for name in ("make_mesh", "init_state_sharded", "make_sharded_step",
                 "resolve_image_sharded", "init_planes_sharded",
                 "make_regen_sharded_step", "planes_to_state",
                 "make_wavefront_sharded_step", "make_sample_sharded_step",
                 "make_wavefront_budget_sharded_step",
                 "make_regen_budget_sharded_step", "build_regen_budget_aux",
                 "resolve_planes"):
        assert callable(getattr(sh, name)), name
