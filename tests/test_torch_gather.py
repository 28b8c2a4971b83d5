"""The final gather's glue around its two traces (``csrc/gbuffer.cu``'s
``gather_dirs_kernel`` and ``gather_resolve_kernel``, bound by
``ops/gbuffer.py``): the entry points ``shade.gather_dirs`` and
``shade.resolve_gather`` run the plain versions for CPU tensors and launch
nothing. ``gather_dirs_plain`` is held bit for bit to the frame's former
code, which this file keeps for its tile reorder (tiled and raster order, a
rank's chunk of the rays, primary misses, degenerate normals);
``resolve_gather_plain`` is held to what each output means, lane by lane
(dense and hash frames, each ``contribution_secondary_*`` flag off, the
debug view, AO hits, final-gather hits and misses, leaf rows past an
instance's cell cap, -0.0 radiance and direct light). The frame through
the plain versions is held to the JAX reference by ``test_torch_frame.py``
and ``test_torch_hash_frame.py``. The library's build, names and bindings
are ``tests/test_torch_csrc.py``'s. The tests marked ``gpu`` hold both
kernels, and frames through them, equal to the plain versions on the card
in every bit (``chip_smoke.py``'s phase 28); run them there with
``--noconftest``."""

import dataclasses

import pytest
import torch
from torch_card import card, chip_smoke  # noqa: F401

from dust_tpu_torch import config
from dust_tpu_torch.ops import camera as cameralib
from dust_tpu_torch.ops import gbuffer, shade
from dust_tpu_torch.ops import gi_cache as gilib
from dust_tpu_torch.ops import noise as noiselib
from dust_tpu_torch.ops import packing as pk
from dust_tpu_torch.ops import sky as skylib
from dust_tpu_torch.render import pipeline
from dust_tpu_torch.render.scene import build_device_scene
from dust_tpu_torch.vox import procgen
from dust_tpu_torch.vox.loader import load_vox_scene

EYE, TARGET = (35.0, 12.0, 60.0), (35.0, 10.0, 0.0)
WIDTH, HEIGHT = 128, 32


@pytest.fixture(scope="module")
def scene():
    """Two teapots, the second turned by the teapot's motion: two
    instances of two models, each with its own cell base and cap."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    vox = load_vox_scene(procgen.teapot_scene_bytes())
    second = procgen.add_teapot(vox, offset=(70.0, 0.0, 10.0))
    s = build_device_scene(vox, "cpu")
    o2w = s.obj_to_world.numpy()
    for f in (6, 7):
        s = s.with_transforms(procgen.teapot_motion(o2w, second, f))
    yield s
    torch.set_num_threads(threads)


def _settings(cache="dense", **changes):
    s = config.RenderSettings(width=WIDTH, height=HEIGHT, gi_cache=cache,
                              traversal_backend="pallas")
    if cache == "hash":
        s = dataclasses.replace(
            s, spatial_hash=dataclasses.replace(s.spatial_hash,
                                                capacity=1 << 14),
            surfels=dataclasses.replace(s.surfels, pool_size=1024))
    return dataclasses.replace(s, **changes)


def _frame(scene, settings, frames=3):
    """Renders ``frames`` frames on the CPU; returns the arguments of the
    gather's entry points in the last (gather_dirs' positional arguments,
    resolve_gather's and its keywords) and the launch counts before and
    after."""
    cam = cameralib.camera_settings(cameralib.look_at(EYE, TARGET), 0.9,
                                    0.1, 1e4, WIDTH, HEIGHT, "cpu")
    bn = noiselib.load_blue_noise("cpu")
    sky = skylib.bake_sky(settings.sunlight, "cpu")
    state = pipeline.make_frame_state(settings, scene, "cpu")
    calls = {}
    entry = shade.gather_dirs, shade.resolve_gather

    def dirs(*a):
        calls["dirs"] = a
        return entry[0](*a)

    def resolve(*a, **kw):
        calls["resolve"] = (a, kw)
        return entry[1](*a, **kw)

    before = dict(gbuffer.LAUNCHES)
    shade.gather_dirs, shade.resolve_gather = dirs, resolve
    try:
        for _ in range(frames):
            img, _aux, state = pipeline.render_frame(
                scene, state, cam, sky, bn.unitvec3_cosine, bn.scalar,
                settings)
    finally:
        shade.gather_dirs, shade.resolve_gather = entry
    assert bool(torch.isfinite(img).all())
    return calls["dirs"], calls["resolve"], before, dict(gbuffer.LAUNCHES)


# The frame's former code of the gather directions, kept as the plain
# version's reference for its tile reorder.

def _former_dirs(normal, hit, bn_cosine, layer, offset, rand, W, H, tiled,
                 lo, hi, thr):
    to_tiles, _ = pipeline._tiling(H, W, tiled)
    cos_sample = to_tiles(noiselib.bn_fetch(
        bn_cosine, layer, offset, rand, H, W))[lo:hi] * 2.0 - 1.0
    gi_dir = pk.rotate_vector_by_normal(normal, cos_sample)
    gi_dir = torch.where(hit[:, None], gi_dir,
                         gi_dir.new_tensor([0.0, 1.0, 0.0]))
    return gi_dir, torch.where(hit, thr, -1.0).float()


def _same(a, b):
    """Equal in dtype, shape and every bit (-0.0 is not 0.0)."""
    if a.dtype != b.dtype or a.shape != b.shape:
        return False
    if a.dtype == torch.float32:
        return torch.equal(a.view(torch.int32), b.view(torch.int32))
    return torch.equal(a, b)


def _held(got, want):
    assert list(got) == list(want)
    for k in want:
        assert _same(got[k], want[k]), k


# ------------------------------------------------------- the directions

@pytest.mark.parametrize("width, height, tiled, lo, hi", [
    (256, 64, True, 0, None), (256, 64, True, 4096, 8192),
    (96, 54, False, 0, None), (96, 54, False, 17, 3000)])
def test_gather_dirs_plain_is_the_frame_code(scene, width, height, tiled,
                                             lo, hi):
    """Made-up normals (primary misses, degenerate normals, one exactly
    -z) over the rays [lo, hi) in the trace's order: the directions and
    the AO t_max bit for bit the frame's former code; on the CPU the entry
    point is the plain version and launches nothing."""
    n = width * height
    hi = n if hi is None else hi
    dirs, _ = chip_smoke()._gather_edge_inputs(scene, 1 << 14, "cpu")
    normal, hit = (x[lo:hi].contiguous() for x in dirs[:2])
    assert bool((normal[:, 2] < -0.99999).any()) and not bool(hit.all())
    args = (normal, hit, dirs[2], 37, (7, 183), 28011, width, height, tiled,
            lo, hi, 8.0)
    before = dict(gbuffer.LAUNCHES)
    got = shade.gather_dirs(*args)
    want = _former_dirs(*args)
    assert gbuffer.LAUNCHES == before
    for a, b, c in zip(got, shade.gather_dirs_plain(*args), want):
        assert _same(a, c) and _same(b, c)
    assert bool(torch.isfinite(got[0]).all())


@pytest.mark.parametrize("args", [
    (100, 72, True, 0, 7200),       # does not divide into 8x128 tiles
    (256, 64, True, 10, 5),         # lo > hi
    (256, 64, False, 0, 256 * 64 + 1),
    (256, 64, False, -1, 10)])
def test_gather_dirs_checks_its_range(args):
    width, height, tiled, lo, hi = args
    m = max(hi - lo, 0)
    with pytest.raises(ValueError):
        shade.gather_dirs(torch.zeros(m, 3), torch.zeros(m, dtype=torch.bool),
                          torch.zeros(64, 128, 128, 3), 0, (7, 183), 0,
                          width, height, tiled, lo, hi, 8.0)


# ------------------------------------------------------------ the resolve

FLAGS = [(True, True), (False, True), (True, False), (False, False)]
_MINUS_ZERO = -(1 << 31)  # the bits of -0.0 as int32


def _resolve_means(args, out, cells):
    """``resolve_gather_plain``'s outputs ``out`` on ``args`` (less its
    keywords) mean what its contract says, lane by lane."""
    (scene, fg, ao, hit_loc, gi_dir, hit, direct, sky_out, _cache,
     sky_state, bounce, skylight) = args
    fg_active = hit & ~ao.hit
    fg_hit = fg_active & fg.hit
    sky_ray = fg_active & ~fg.hit
    assert list(out) == ["radiance", "hitdist", "illum"] + (
        ["face", "count", "center"] if cells else [])
    radiance, hitdist, illum = out["radiance"], out["hitdist"], out["illum"]
    assert radiance.dtype == hitdist.dtype == illum.dtype == torch.float32
    # A primary miss shows the sky it saw and lies far.
    assert _same(radiance[~hit], sky_out[~hit])
    assert bool((hitdist[~hit] == 100000.0).all())
    # A hit: direct plus indirect light, at the AO or else the final
    # gather's hit (0 when neither hit).
    assert _same(radiance[hit], direct[hit] + illum[hit])
    assert _same(hitdist[hit & ao.hit], ao.t[hit & ao.hit])
    assert _same(hitdist[fg_hit], fg.t[fg_hit])
    assert bool((hitdist[sky_ray] == 0.0).all())
    # illum adds to zeros, so no lane holds -0.0; it is 0 where the final
    # gather did not run, the sky where its ray left the scene, and the
    # bounce where it hit.
    assert not bool((illum.view(torch.int32) == _MINUS_ZERO).any())
    assert not bool(illum[~fg_active].any())
    if skylight:
        sky = skylib.sky_radiance(sky_state, gi_dir)
        assert torch.equal(illum[sky_ray], sky[sky_ray])
    else:
        assert not bool(illum[sky_ray].any())
    if not bounce:
        assert not bool(illum[fg_hit].any())
    if cells:
        face = shade.entry_face(scene, fg, hit_loc, gi_dir)
        assert _same(out["face"], face.to(torch.int32))
        center = shade.entry_leaf_center(scene, fg, hit_loc, gi_dir)
        assert _same(out["center"], center)
        count = out["count"]
        assert count.dtype == torch.float32
        assert not bool(count[~fg_hit].any())
        assert bool((count == count.round()).all())
        assert bool(((count >= 0) & (count <= 404)).all())
        if bounce:
            # The bounce of an empty row is 0.
            assert not bool(illum[fg_hit & (count == 0)].any())
    return fg_hit


@pytest.mark.parametrize("cells", [False, True])
@pytest.mark.parametrize("bounce, skylight", FLAGS)
def test_resolve_gather_plain_on_made_up_rays(scene, cells, bounce,
                                              skylight):
    """Made-up rays with every edge (AO hits, final-gather hits on both
    instances and misses, rows past a cell cap, empty rows, -0.0 halves
    and -0.0 direct light): each output means what the contract says, with
    and without the hash frame's enqueue outputs; the bounce does not
    depend on the skylight flag; on the CPU the entry point is the plain
    version and launches nothing."""
    _, resolve = chip_smoke()._gather_edge_inputs(scene, 1 << 12, "cpu",
                                                  seed=3)
    args = (*resolve[:10], bounce, skylight)
    _s, fg, _ao, _o, _d, hit = args[:6]
    caps = torch.tensor(gilib.cell_layout(scene)[1])
    past = (fg.inst >= 0) & (fg.row >= caps[fg.inst.clamp(min=0).long()])
    assert bool(past.any()) and bool((fg.inst >= 0).any())
    assert bool((fg.inst == 1).any()) and not bool(hit.all())
    before = dict(gbuffer.LAUNCHES)
    got = shade.resolve_gather(*args, cells=cells)
    assert gbuffer.LAUNCHES == before
    _held(got, shade.resolve_gather_plain(*args, cells=cells))
    fg_hit = _resolve_means(args, got, cells)
    if bounce:
        other = shade.resolve_gather_plain(*args[:11], not skylight,
                                           cells=cells)
        assert _same(got["illum"][fg_hit], other["illum"][fg_hit])
        assert bool(got["illum"][fg_hit].any())


@pytest.mark.parametrize("cache", ["dense", "hash"])
@pytest.mark.parametrize("bounce, skylight", FLAGS)
def test_the_frame_gathers_through_the_plain_versions(scene, cache, bounce,
                                                      skylight):
    """A CPU frame's own arguments (the hash frame's with its working set
    and enqueue outputs), with the contribution flags off too: the
    directions bit for bit the former code, and what the resolve returned
    means what its contract says; the frame's calls took the plain path
    and launched nothing."""
    dirs, (args, kw), before, after = _frame(
        scene, _settings(cache, contribution_secondary_spatial_hash=bounce,
                         contribution_secondary_skylight=skylight)
        if bounce or skylight else _settings(cache))
    assert after == before
    assert kw == dict(cells=cache == "hash", debug_illum=None)
    gi_dir, t_max = shade.gather_dirs_plain(*dirs)
    want = _former_dirs(*dirs)
    assert _same(gi_dir, want[0]) and _same(t_max, want[1])
    assert _same(args[4], gi_dir)
    args = (*args[:10], bounce, skylight)
    out = shade.resolve_gather_plain(*args, cells=kw["cells"])
    fg_hit = _resolve_means(args, out, kw["cells"])
    fg, hit = args[1], args[5]
    assert int(hit.sum()) > 500 and int(fg_hit.sum()) > 10
    assert torch.bincount(fg.inst[fg.inst >= 0].long()).min() > 5


def test_debug_view_replaces_illum(scene):
    """``debug_illum`` (the debug view) replaces illum where the primary
    ray hit, and with it the radiance there; nothing else changes."""
    _, resolve = chip_smoke()._gather_edge_inputs(scene, 1 << 12, "cpu",
                                                  seed=4)
    dbg = torch.rand(1 << 12, 3, generator=torch.Generator().manual_seed(4))
    dbg[::5] = -0.0
    got = shade.resolve_gather(*resolve, cells=True, debug_illum=dbg)
    plain = shade.resolve_gather_plain(*resolve, cells=True)
    hit, direct = resolve[5], resolve[6]
    assert _same(got["illum"][hit], dbg[hit])
    assert _same(got["illum"][~hit], plain["illum"][~hit])
    assert _same(got["radiance"][hit], direct[hit] + dbg[hit])
    assert _same(got["radiance"][~hit], plain["radiance"][~hit])
    for k in ("hitdist", "face", "count", "center"):
        assert _same(got[k], plain[k]), k


def test_gather_wants_the_sky_for_skylight(scene):
    """The kernel's wrapper refuses skylight without a sky model (the
    kernel would read null pointers) before it looks at the device."""
    _, resolve = chip_smoke()._gather_edge_inputs(scene, 256, "cpu")
    args = (*resolve[:9], None, True, True)
    with pytest.raises(ValueError, match="sky_state"):
        gbuffer.gather(*args, False)
    with pytest.raises(ValueError, match="unsupported device"):
        gbuffer.gather(*args[:10], True, False, False)


def test_hash_frame_on_the_cpu_launches_nothing(scene):
    """A hash GI frame on CPU tensors: no kernel launched, nothing built."""
    handle = gbuffer.LIBRARY.handle
    _d, _r, before, after = _frame(scene, _settings("hash"), frames=2)
    assert after == before
    assert gbuffer.LIBRARY.handle is handle


# ----------------------------------------------------------- on the card

@pytest.mark.gpu
@pytest.mark.parametrize("config, width, height", [
    ("gi", 1920, 1080), ("gi-4k", 3840, 2160),
    ("hash-reference", 1920, 1080)])
def test_kernels_match_plain_on_the_card(card, config, width, height):
    """Both kernels equal to their plain versions in every output and bit
    on a frame's own arguments at the cells' shapes (castle + teapot,
    dense and hash), with the enqueue's outputs both ways, the debug view,
    each flag off, a rank's chunk and raster order; one launch of each a
    frame."""
    smoke = chip_smoke()
    ctx = smoke._setup(card, width, height, config)
    for k in gbuffer.LAUNCHES:
        gbuffer.LAUNCHES[k] = 0
    smoke._frames(ctx, 2)
    assert gbuffer.LAUNCHES == {"primary_rays": 2, "gbuffer_resolve": 2,
                                "gather_dirs": 2, "gather_resolve": 2}
    smoke._gather_case(f"gather {config}", ctx, 2)


@pytest.mark.gpu
@pytest.mark.parametrize("seed", [0, 1])
def test_edges_match_plain_on_the_card(card, seed):
    """Made-up rays with every edge, through both kernels and the plain
    versions: equal in every output and bit."""
    smoke = chip_smoke()
    ctx = smoke._setup(card, 256, 64)
    smoke._gather_edges("gather edges", ctx["scene"], card, seed)


@pytest.mark.gpu
@pytest.mark.parametrize("debug", [False, True])
@pytest.mark.parametrize("config", ["gi", "hash-reference"])
def test_frame_matches_plain_on_the_card(card, config, debug):
    """A GI frame through the kernels and through the plain versions, from
    one state, with and without the debug view: output, aux and new state
    equal."""
    smoke = chip_smoke()
    kw = dict(capacity=1 << 16, pool=4096) if config != "gi" else {}
    ctx = smoke._setup(card, 256, 128, config,
                       debug_visualize_spatial_hash=debug, **kw)
    smoke._gather_frame_equal("gather frame", ctx, 3)
