"""The spatial hash's kernels (``csrc/spatial_hash.cu``, bound by
``ops/spatial_hash.py``). On the CPU: the insert's suffix sums as the
kernels schedule them (1024-key blocks, their totals' tree, each key's
fold) written out in torch, word for word equal to ``_scan``; the entry
points ``probe_working_set`` and ``hash_insert`` on CPU tensors equal to
the frozen plain code of ``benchmark/reference`` and launching nothing;
the frame's spans ``dust.hash.probe`` and ``dust.hash.insert`` (the
kernels' names, build and bindings are ``tests/test_torch_csrc.py``'s).
Torch on one thread, at most 2^16 slots and
4,096 keys. The tests marked ``gpu`` hold every kernel, and a 1080p hash
frame through them, equal to the plain versions on the card at the
castle-hash cell's sizes (``chip_smoke.py``'s phase 26); run them there
with ``--noconftest``."""

import dataclasses

import pytest
import torch
from torch.profiler import ProfilerActivity, profile
from torch_card import card, chip_smoke  # noqa: F401

from benchmark.reference.ops import gi_cache as ref_gi
from benchmark.reference.ops import spatial_hash as ref_sh
from dust_tpu_torch import config
from dust_tpu_torch.ops import camera as cameralib
from dust_tpu_torch.ops import gi_cache as gilib
from dust_tpu_torch.ops import spatial_hash as sh
from dust_tpu_torch.ops.noise import load_blue_noise
from dust_tpu_torch.ops.sky import bake_sky
from dust_tpu_torch.render import pipeline
from dust_tpu_torch.render.scene import build_device_scene
from dust_tpu_torch.vox import procgen
from dust_tpu_torch.vox.loader import load_vox_scene

EYE, TARGET = (26.0, 14.0, 32.0), (4.0, -4.0, 0.0)


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def teapot():
    return build_device_scene(load_vox_scene(procgen.teapot_scene_bytes()),
                              "cpu")


# ------------------------------------------------ the scan's block schedule

def _combine(af, av, bf, bv):
    return af | bf, torch.where(bf[..., None], bv, av + bv)


def _pairs(f, v):
    """One level up a tree: each aligned pair combined (a tail dropped)."""
    m = f.shape[-1] // 2 * 2
    return _combine(f[..., 0:m:2], v[..., 0:m:2, :], f[..., 1:m:2],
                    v[..., 1:m:2, :])


def _block_schedule(f, v, log_block):
    """``_scan`` as the kernels compute it: each block of 2^log_block keys
    sums its tree (scan_up), the full blocks' totals sum theirs and fold
    each block prefix (scan_blocks), and each key folds its prefix from
    its block's fold and its block's tree (scan): from the highest set bit
    of the prefix length to the lowest. Returns the values."""
    n = f.shape[0]
    size = 1 << log_block
    nblocks, nfull = -(-n // size), n // size
    pad = nblocks * size - n
    fb = torch.cat([f, f.new_zeros(pad)]).reshape(nblocks, size)
    vb = torch.cat([v, v.new_zeros((pad, 4))]).reshape(nblocks, size, 4)
    levels = [(fb, vb)]
    for _ in range(log_block):
        levels.append(_pairs(*levels[-1]))
    tree = [(levels[-1][0][:nfull, 0], levels[-1][1][:nfull, 0])]
    while tree[-1][0].shape[0] >= 2:
        tree.append(_pairs(*tree[-1]))

    def fold(p, acc, have, entry, levels_used):
        """Each prefix length p's fold over its set bits, high to low:
        the first block starts it, each next one combines into it."""
        for level in range(levels_used - 1, -1, -1):
            bit = ((p >> level) & 1).bool()
            ef, ev = entry(level, (p >> level) - 1, p)
            comb = torch.where(ef[:, None], ev, acc + ev)
            acc = torch.where((bit & have)[:, None], comb,
                              torch.where((bit & ~have)[:, None], ev, acc))
            have = have | bit
        return acc

    def tree_entry(level, idx, p):
        tf, tv = tree[level]
        idx = idx.clamp(0, tf.shape[0] - 1)
        return tf[idx], tv[idx]

    p = torch.arange(1, nfull + 1)
    block_fold = fold(p, torch.zeros((nfull, 4)),
                      torch.zeros(nfull, dtype=torch.bool), tree_entry,
                      len(tree))

    def block_entry(level, idx, p):
        lf, lv = levels[level]
        b = (p - 1) >> log_block
        local = (idx - (b << (log_block - level))).clamp(0, lf.shape[1] - 1)
        return lf[b, local], lv[b, local]

    p = torch.arange(1, n + 1)
    q = p >> log_block
    start = (block_fold[(q - 1).clamp(min=0)] if nfull
             else torch.zeros((n, 4)))
    start = torch.where((q > 0)[:, None], start, 0.0)
    return fold(p, start, q > 0, block_entry, log_block)


def _run_pattern(n, pattern, g):
    """Segment starts of ``pattern`` over n keys."""
    if pattern == "every":
        return torch.ones(n, dtype=torch.bool)
    if pattern == "one_run":
        return torch.zeros(n, dtype=torch.bool)
    if pattern == "alternate":
        return torch.arange(n) % 2 == 0
    if pattern == "threes":
        return torch.arange(n) % 3 == 1
    share = {"half": 0.5, "sparse": 0.02}[pattern]
    return torch.rand(n, generator=g) < share


def _values(n, g):
    """float32 values over nine decades, some zero and some negative, so
    that sums in another order differ."""
    v = torch.rand((n, 4), generator=g) * 10.0 ** (
        torch.rand((n, 1), generator=g) * 9.0 - 4.0)
    v = torch.where(torch.rand((n, 4), generator=g) < 0.05, 0.0, v)
    return torch.where(torch.rand((n, 4), generator=g) < 0.05, -v, v)


PATTERNS = ["every", "one_run", "alternate", "threes", "half", "sparse"]


@pytest.mark.parametrize("lengths, log_blocks", [
    (list(range(1, 71)), (1, 2, 3, 10)), ([1023], (3, 10)),
    ([1024], (3, 10)), ([1025], (3, 10)), ([345_600], (10,))],
    ids=["1-70", "1023", "1024", "1025", "345600"])
def test_block_schedule_is_scan_word_for_word(lengths, log_blocks):
    """The kernels' schedule of the segmented scan gives ``_scan``'s
    float32 sums bit for bit, at every length given (odd tails, partial
    blocks, no full block), for every run pattern and block size."""
    g = torch.Generator().manual_seed(sum(lengths))
    for n in lengths:
        v = _values(n, g)
        for pattern in PATTERNS:
            f = _run_pattern(n, pattern, g)
            _, want = sh._scan(f, v)
            for log_block in log_blocks:
                got = _block_schedule(f, v, log_block)
                assert torch.equal(got.view(torch.int32),
                                   want.view(torch.int32)), \
                    (n, pattern, log_block)


def test_another_order_gives_other_sums():
    """The check has teeth: at the cell's size a segmented sum in another
    order (float64 running sums, rounded) differs from ``_scan`` in some
    words."""
    g = torch.Generator().manual_seed(5)
    n = 345_600
    v = _values(n, g)
    f = _run_pattern(n, "sparse", g)
    f[0] = True
    _, want = sh._scan(f, v)
    run = torch.cumsum(f.long(), 0)
    total = torch.cumsum(v.double(), 0)
    starts = torch.nonzero(f)[:, 0]
    before = torch.cat([total.new_zeros((1, 4)), total[:-1]])[starts]
    other = (total - before[run - 1]).float()
    assert not torch.equal(other.view(torch.int32), want.view(torch.int32))


# ---------------------------------------------------- the entry points

def _reference_hash(h):
    return ref_sh.SpatialHash(table=h.table.clone())


def _filled_hash(scene, capacity, frames=2):
    """A hash of ``capacity`` slots with values inserted at the scene's
    working-set keys (so probes find some)."""
    centers, vleaf = pipeline._cell_enumeration(scene)
    cells = centers.shape[0]
    face6 = torch.arange(6, dtype=torch.int32)[:, None].expand(6, cells)
    qpos6, face6 = sh.spatial_hash_key(centers.repeat(6, 1),
                                       face6.reshape(-1), 4.0)
    g = torch.Generator().manual_seed(3)
    h = sh.make_spatial_hash(capacity, "cpu")
    for f in range(frames):
        pick = torch.randint(0, qpos6.shape[0], (2048,), generator=g)
        h = sh.hash_insert(h, qpos6[pick], face6[pick],
                           torch.rand((2048, 3), generator=g) * 4.0, f)
    return h


def test_probe_working_set_on_the_cpu_is_the_frozen_code(teapot):
    """CPU tensors: the working set, whole and as a rotating slice, is the
    frozen plain code's ``hash_get`` packed by ``pack_working_set_rows``
    (``benchmark/reference``), also through the frame's ``_working_set``;
    nothing launches."""
    h = _filled_hash(teapot, 1 << 14)
    centers, vleaf = pipeline._cell_enumeration(teapot)
    cells = centers.shape[0]
    rows = 6 * cells
    face6 = torch.arange(6, dtype=torch.int32)[:, None].expand(6, cells)
    qpos6, face6 = ref_sh.spatial_hash_key(centers.repeat(6, 1),
                                           face6.reshape(-1), 4.0)
    valid6 = vleaf.repeat(6)
    found, rad, cnt = ref_sh.hash_get(_reference_hash(h), qpos6, face6)
    assert 0 < int((found & valid6).sum()) < rows
    alb = gilib.albedo_words(teapot)
    want = ref_gi.pack_working_set_rows(
        rad, torch.where(found & valid6, cnt, 0), alb[:, None])
    before = dict(sh.LAUNCHES)
    got = sh.probe_working_set(h, centers, vleaf, 4.0, albedo=alb)
    assert torch.equal(got, want)
    ws = want.clone()
    ws[:, :2] = 7
    lo, hi = rows // 3, rows // 3 + rows // 4
    got_slice = sh.probe_working_set(h, centers, vleaf, 4.0, ws=ws, lo=lo,
                                     hi=hi)
    want_slice = ws.clone()
    want_slice[lo:hi, :2] = want[lo:hi, :2]
    assert torch.equal(got_slice, want_slice)

    settings = config.RenderSettings(gi_cache="hash")
    state = pipeline.FrameState(
        gi=h, surfels=torch.zeros((0, 4)), denoiser=None,
        exposure_avg=torch.zeros(()), frame_index=0,
        prev_view_proj=torch.zeros((4, 4)))
    reads, gi_ws = pipeline._working_set(teapot, state, settings, 0)
    assert torch.equal(reads.table, want) and gi_ws is None
    sliced = dataclasses.replace(
        settings, spatial_hash=dataclasses.replace(settings.spatial_hash,
                                                   ws_refresh_slices=3))
    state = dataclasses.replace(state, gi_ws=gilib.DenseGICache(table=ws))
    size = -(-rows // 3)
    reads, gi_ws = pipeline._working_set(teapot, state, sliced, 2)
    want_slice = ws.clone()
    start = min(2 * size, rows - size)
    want_slice[start:start + size, :2] = want[start:start + size, :2]
    assert torch.equal(reads.table, want_slice) and gi_ws is reads
    assert sh.LAUNCHES == before and set(before.values()) == {0}


@pytest.mark.parametrize("n, max_updates, all_valid", [
    (4096, None, False), (4096, 300, False), (1500, 10_000, True),
    (1, None, True)])
def test_hash_insert_on_the_cpu_is_the_frozen_code(n, max_updates,
                                                   all_valid):
    """CPU tensors: ``hash_insert`` is the frozen plain code's insert
    (``benchmark/reference``), keys repeating within a batch and across
    two, a full group evicting, the cap binding or not; nothing
    launches."""
    g = torch.Generator().manual_seed(n)
    cells = max(n // 3, 1)
    cq = torch.randint(-300, 300, (cells, 3), generator=g, dtype=torch.int32)
    cf = torch.randint(0, 6, (cells,), generator=g, dtype=torch.int32)
    h = sh.make_spatial_hash(1 << 12, "cpu")
    ref = _reference_hash(h)
    before = dict(sh.LAUNCHES)
    for frame in range(2):
        pick = torch.randint(0, cells, (n,), generator=g)
        value = torch.rand((n, 3), generator=g) * 10.0 ** (
            torch.rand((n, 1), generator=g) * 4.0 - 2.0)
        valid = None if all_valid else torch.rand(n, generator=g) < 0.8
        h = sh.hash_insert(h, cq[pick], cf[pick], value, frame, valid=valid,
                           max_updates=max_updates)
        ref = ref_sh.hash_insert(ref, cq[pick], cf[pick], value, frame,
                                 valid=valid, max_updates=max_updates)
        assert torch.equal(h.table, ref.table)
    assert int((h.table.view(-1, 4, 4)[..., 0] != 0).sum()) > 0
    assert sh.LAUNCHES == before and set(before.values()) == {0}


# ----------------------------------------------------------- the spans

def _frame_spans(scene, gi_cache):
    settings = config.RenderSettings(
        width=96, height=54, gi_cache=gi_cache, traversal_backend="pallas",
        spatial_hash=config.SpatialHashSettings(capacity=1 << 16),
        surfels=config.SurfelSettings(pool_size=4096))
    cam = cameralib.camera_settings(
        cameralib.look_at(EYE, TARGET), 0.9, settings.camera.near,
        settings.camera.far, 96, 54, "cpu")
    bn = load_blue_noise("cpu")
    state = pipeline.make_frame_state(settings, scene, "cpu")
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        pipeline.render_frame(scene, state, cam,
                              bake_sky(settings.sunlight, "cpu"),
                              bn.unitvec3_cosine, bn.scalar, settings)
    return sorted((e.start_ns(), e.end_ns(), e.name())
                  for e in prof.profiler.kineto_results.events()
                  if e.name().startswith("dust.") and e.is_user_annotation())


def test_hash_frame_opens_the_hash_spans(teapot):
    """A 96x54 hash frame under a profiler opens ``dust.hash.probe`` once,
    inside ``dust.gather``, and ``dust.hash.insert`` once, inside
    ``dust.refresh``; a dense frame opens neither."""
    spans = _frame_spans(teapot, "hash")

    def one(name):
        found = [s for s in spans if s[2] == name]
        assert len(found) == 1, (name, spans)
        return found[0]

    for inner, outer in (("dust.hash.probe", "dust.gather"),
                         ("dust.hash.insert", "dust.refresh")):
        s, e, _ = one(inner)
        os_, oe, _ = one(outer)
        assert os_ <= s <= e <= oe
    names = {s[2] for s in _frame_spans(teapot, "dense")}
    assert "dust.gather" in names
    assert not {"dust.hash.probe", "dust.hash.insert"} & names
    assert sh.LIBRARY.handle is None  # the CPU frame built, loaded nothing


# ----------------------------------------------------------- on the card

@pytest.mark.gpu
def test_codec_matches_plain_on_the_card(card):
    """The kernels' LogLuv decode on every 32-bit word and encode on 2^24
    colours, equal to packing.py's on the card."""
    chip_smoke()._hash_codec_equal(card)


@pytest.mark.gpu
@pytest.mark.parametrize("capacity, n, cap, all_valid", [
    (1 << 25, 720 * 480, 1 << 17, False), (1 << 16, 1000, None, False),
    (1 << 16, 1024, None, True), (1 << 16, 4097, 100, False)],
    ids=["cell", "no-full-block", "one-block", "tail-capped"])
def test_insert_matches_plain_on_the_card(card, capacity, n, cap,
                                          all_valid):
    """Three rounds of the insert's kernels equal to hash_insert_plain on
    the card: at the cell's size (2^25 slots, 345,600 keys) with repeats,
    evictions and the cap reached, and small."""
    out = chip_smoke()._hash_insert_case(f"insert {n}", card, capacity, n,
                                          cap, all_valid=all_valid)
    assert out["evictions"] > 0
    if n == 720 * 480:
        assert out["cap_bound"]


@pytest.mark.gpu
def test_probe_and_frame_match_plain_on_the_card(card):
    """The 1080p hash frame (castle + teapot, 2^25 slots, a 720x480 pool):
    one launch of each kernel a frame; the working-set probe on its table
    equal to the plain version, whole and in rotating slices; a frame
    through the kernels equal to one through the plain versions."""
    smoke = chip_smoke()
    ctx = smoke._setup(card, 1920, 1080, "hash-reference")
    for k in sh.LAUNCHES:
        sh.LAUNCHES[k] = 0
    smoke._frames(ctx, 3)
    assert {k: sh.LAUNCHES[k] for k in smoke.HASH_KERNELS} == dict.fromkeys(
        smoke.HASH_KERNELS, 3)
    smoke._hash_probe_case("probe", ctx)
    smoke._hash_frame_equal("hash frame", ctx, 3)
