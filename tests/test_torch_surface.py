"""The rest of the reference's public surface in the port, against the
reference on the same numpy inputs: the reservoirs, the octant sort and
``BlueNoise.sample``, ``srgb_oetf``, the ``SpatialHash`` field views, and
every name the reference's packages export.

Tolerances:

* ``reservoir_update``: counts, weight sums, directions and radiances
  bit for bit (equal directions and radiances after three steps of
  distinct samples are equal ``take`` choices);
* ``pack_reservoir``: counts and weights bit for bit; each 16-bit half
  of the octahedral direction word within 1 (the reference runs under
  ``jax.jit``, where XLA may contract the ``* 0.5 + 0.5`` of the
  octahedral map); the LogLuv word as ``tests/test_torch_hash.py``
  holds it: u and v codes exact, the 14-bit log-luminance code within
  one step on at most 1e-4 of the words (XLA's float32 ``log`` against
  PyTorch's);
* ``unpack_reservoir`` of the reference's words: radiance within 1e-6 of
  each colour's largest component (XLA's ``exp``), direction dot
  products above 0.9999;
* ``octant_sort_regions``, ``BlueNoise.sample``, the field views: equal;
* ``srgb_oetf``: within 1e-6;
* the denoiser history's views: colour and history length equal, hit
  distance within 1e-6 relative.
"""

import ast
import importlib
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from dust_tpu.ops import noise as jnoise
from dust_tpu.ops import reservoir as jres
from dust_tpu.ops import spatial_hash as jsh
from dust_tpu.utils import color as jcolor
from dust_tpu_torch.ops import noise as tnoise
from dust_tpu_torch.ops import reservoir as tres
from dust_tpu_torch.ops import spatial_hash as tsh
from dust_tpu_torch.utils import color as tcolor

REPO = Path(__file__).resolve().parents[1]


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """The port's CPU ops on one thread here: at these sizes threads buy
    little, and idle OpenMP workers would contend with other test
    processes for the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _t(a):
    return torch.as_tensor(np.array(a, copy=True, order="C"))


def _u32(a):
    return np.asarray(a).astype(np.int64) & 0xFFFFFFFF


# ---------------------------------------------------------------- reservoirs

N_RES = 4096


def _samples(step, n=N_RES):
    """Step ``step``'s new samples: unit directions, HDR radiance (zeros
    and a negative channel among them), weights and uniforms."""
    rng = np.random.default_rng(100 + step)
    d = rng.normal(size=(n, 3))
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    rad = np.exp(rng.normal(0.0, 2.0, size=(n, 3)))
    rad[:32] = 0.0
    rad[32:48, 1] = -0.5
    w = rng.exponential(1.0, size=n)
    u = rng.random(n)
    return [x.astype(np.float32) for x in (d, rad, w, u)]


@pytest.fixture(scope="module")
def reservoirs():
    """The reference's and the port's reservoirs after three updates."""
    jr = jres.make_reservoirs(N_RES)
    tr = tres.make_reservoirs(N_RES, "cpu")
    update = jax.jit(jres.reservoir_update)
    for step in range(3):
        d, rad, w, u = _samples(step)
        jr = update(jr, d, rad, w, u)
        tr = tres.reservoir_update(tr, _t(d), _t(rad), _t(w), _t(u))
    return jr, tr


def test_reservoir_update_matches_reference(reservoirs):
    jr, tr = reservoirs
    for name in ("sample_count", "weight_sum", "direction", "radiance"):
        np.testing.assert_array_equal(getattr(tr, name).numpy(),
                                      np.asarray(getattr(jr, name)), name)
    assert (tr.sample_count.numpy() == 3).all()
    # Each step's samples differ, so equal directions are equal choices;
    # the choices must not all go one way.
    kept = [(tr.direction.numpy() == _samples(s)[0]).all(-1).mean()
            for s in range(3)]
    assert all(0.05 < k < 0.95 for k in kept), kept


def test_pack_reservoir_matches_reference(reservoirs):
    jr, tr = reservoirs
    jc, jd, jl, jw = jax.jit(jres.pack_reservoir)(jr)
    tc, td, tl, tw = tres.pack_reservoir(tr)
    np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))
    np.testing.assert_array_equal(tw.numpy(), np.asarray(jw))
    jd, jl, td, tl = _u32(jd), _u32(jl), td.numpy(), tl.numpy()
    assert td.min() >= 0 and td.max() < 2**32
    for shift in (16, 0):
        half = ((td >> shift) & 0xFFFF) - ((jd >> shift) & 0xFFFF)
        assert np.abs(half).max() <= 1
    assert (((tl >> 9) & 511) == ((jl >> 9) & 511)).all()
    assert ((tl & 511) == (jl & 511)).all()
    dl = (tl >> 18) - (jl >> 18)
    assert np.abs(dl).max() <= 1
    assert (dl != 0).mean() <= 1e-4, (dl != 0).mean()


def test_unpack_reservoir_matches_reference(reservoirs):
    jr, _ = reservoirs
    words = jax.jit(jres.pack_reservoir)(jr)
    ref = jax.jit(jres.unpack_reservoir)(*words)
    count, dir_u, rad_u, weight = (np.asarray(w) for w in words)
    got = tres.unpack_reservoir(_t(count), _t(_u32(dir_u)), _t(_u32(rad_u)),
                                _t(weight))
    np.testing.assert_array_equal(got.sample_count.numpy(),
                                  np.asarray(ref.sample_count))
    np.testing.assert_array_equal(got.weight_sum.numpy(),
                                  np.asarray(ref.weight_sum))
    jrad = np.asarray(ref.radiance)
    scale = np.maximum(np.abs(jrad).max(axis=-1, keepdims=True), 1e-30)
    assert (np.abs(got.radiance.numpy() - jrad) / scale).max() <= 1e-6
    dots = (got.direction.numpy() * np.asarray(ref.direction)).sum(-1)
    assert dots.min() > 0.9999


def test_make_reservoirs_zero():
    r = tres.make_reservoirs(5, "cpu")
    assert r.sample_count.dtype == torch.int32
    assert r.direction.shape == (5, 3) and not r.weight_sum.any()


# ---------------------------------------------------------------- blue noise

@pytest.fixture(scope="module")
def noise_tables():
    return jnoise.load_blue_noise(), tnoise.load_blue_noise("cpu")


@pytest.mark.parametrize("rows,cols", [(8, 128), (128, 128)])
def test_octant_sort_regions_matches_reference(noise_tables, rows, cols):
    jbn, tbn = noise_tables
    ref = np.asarray(jnoise.octant_sort_regions(jbn.unitvec3_cosine, rows,
                                                cols))
    got = tnoise.octant_sort_regions(tbn.unitvec3_cosine, rows, cols)
    assert isinstance(got, torch.Tensor) and got.device.type == "cpu"
    np.testing.assert_array_equal(got.numpy(), ref)


def test_blue_noise_sample_matches_reference(noise_tables):
    """The indices of tests/test_ops.py::test_sample_indexing."""
    jbn, tbn = noise_tables
    pix = np.asarray([[0, 0], [127, 127], [5, 9]], np.int32)
    ref = jbn.sample(jbn.scalar, jnp.asarray(pix), frame_index=3,
                     offset=(7, 183), rand=11)
    got = tbn.sample(tbn.scalar, torch.as_tensor(pix), frame_index=3,
                     offset=(7, 183), rand=11)
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))


# ---------------------------------------------------------------- colour

def test_srgb_oetf_matches_reference():
    rng = np.random.default_rng(8)
    c = np.concatenate([np.linspace(-0.1, 0.01, 4096),
                        rng.exponential(1.0, 8192),
                        [0.0, 0.0031308, 0.0031309, 1.0]]).astype(np.float32)
    got = tcolor.srgb_oetf(torch.as_tensor(c)).numpy()
    for xp in (np, jnp):
        ref = np.asarray(jcolor.srgb_oetf(xp.asarray(c), xp=xp))
        np.testing.assert_allclose(got, ref, rtol=0, atol=1e-6)
    np.testing.assert_array_equal(tcolor.srgb_oetf_np(c),
                                  jcolor.srgb_oetf(c))


# ---------------------------------------------------------------- hash views

def test_spatial_hash_views_match_reference():
    rng = np.random.default_rng(12)
    q = rng.integers(-40, 40, size=(256, 3)).astype(np.int32)
    f = rng.integers(0, 6, size=256).astype(np.int32)
    v = (np.abs(rng.normal(size=(256, 3))) + 0.1).astype(np.float32)
    jh = jsh.make_spatial_hash(4096)
    th = tsh.make_spatial_hash(4096, "cpu")
    for frame in (1, 2):
        jh = jsh.hash_insert(jh, q[::frame], f[::frame], v[::frame], frame)
        th = tsh.hash_insert(th, _t(q[::frame]), _t(f[::frame]),
                             _t(v[::frame]), frame)
    for name in ("fingerprint", "radiance", "last_frame", "sample_count"):
        ref = np.asarray(getattr(jh, name))
        got = getattr(th, name).numpy()
        assert got.shape == (4096,)
        np.testing.assert_array_equal(
            got, _u32(ref) if ref.dtype == np.uint32 else ref, name)
    assert (th.fingerprint.numpy() != 0).sum() > 200
    assert th.sample_count.numpy().max() == 2


# ---------------------------------------------------------------- denoiser

def test_denoiser_state_views_match_reference():
    """The history views on random packed words (hit distances within
    1e-6, a few float32 ulps: XLA's ``exp2`` against PyTorch's)."""
    from dust_tpu.ops import denoise as jdn
    from dust_tpu_torch.ops import denoise as tdn

    rng = np.random.default_rng(13)
    words = rng.integers(0, 2**32, size=(9, 11, 3),
                         dtype=np.uint64).astype(np.uint32)
    ref = jdn.DenoiserState(history=jnp.asarray(words))
    got = tdn.DenoiserState(history=torch.as_tensor(words.view(np.int32)))
    np.testing.assert_array_equal(got.color.numpy(), np.asarray(ref.color))
    np.testing.assert_array_equal(got.history_len.numpy(),
                                  np.asarray(ref.history_len))
    np.testing.assert_allclose(got.hitdist.numpy(), np.asarray(ref.hitdist),
                               rtol=1e-6, atol=0)


# ---------------------------------------------------------------- public names

def _reexports(path: Path) -> set:
    """The names a package's ``__init__`` binds: imported or assigned."""
    names = set()
    for node in ast.parse(path.read_text()).body:
        if isinstance(node, ast.ImportFrom):
            names.update(a.asname or a.name for a in node.names)
        elif isinstance(node, ast.Assign):
            names.update(t.id for t in node.targets
                         if isinstance(t, ast.Name))
    return names


PACKAGES = ["", "render", "voxtree", "vox"]


@pytest.mark.parametrize("sub", PACKAGES)
def test_reexports_have_counterparts(sub):
    init = REPO / "dust_tpu" / sub / "__init__.py"
    names = _reexports(init)
    assert names, init
    port = importlib.import_module(".".join(filter(None, ["dust_tpu_torch",
                                                          sub])))
    ref = importlib.import_module(".".join(filter(None, ["dust_tpu", sub])))
    for name in sorted(names):
        assert hasattr(port, name), f"dust_tpu_torch.{sub}: no {name}"
        if name == "__version__":
            assert port.__version__ == ref.__version__
        else:
            assert getattr(port, name).__name__ == getattr(ref, name).__name__


# Modules and methods not ported, and why: ROADMAP.md, Queue 1. The
# Pallas module's counterpart is ops/hdda.py, under the port's own names;
# the numpy trace oracle never runs on a device.
NOT_PORTED = {"ops/pallas_trace.py", "ops/trace_ref.py"}
METHODS_NOT_PORTED = set()


def _public_defs(path: Path) -> set:
    """Public functions and classes, and each class's public methods and
    properties as ``Class.name``."""
    names = set()
    for node in ast.parse(path.read_text()).body:
        if (isinstance(node, (ast.FunctionDef, ast.ClassDef))
                and not node.name.startswith("_")):
            names.add(node.name)
        if isinstance(node, ast.ClassDef):
            names.update(f"{node.name}.{m.name}" for m in node.body
                         if isinstance(m, ast.FunctionDef)
                         and not m.name.startswith("_"))
    return names


REF_MODULES = sorted(
    p.relative_to(REPO / "dust_tpu").as_posix()
    for p in (REPO / "dust_tpu").rglob("*.py")
    if p.relative_to(REPO / "dust_tpu").as_posix() not in NOT_PORTED)


@pytest.mark.parametrize("path", REF_MODULES)
def test_every_public_function_has_a_counterpart(path):
    """Every public function, class and method of a reference module is
    defined in the port's module of the same name."""
    port = REPO / "dust_tpu_torch" / path
    assert port.exists(), f"dust_tpu_torch/{path} is missing"
    missing = (_public_defs(REPO / "dust_tpu" / path) - _public_defs(port)
               - METHODS_NOT_PORTED)
    assert not missing, f"dust_tpu_torch/{path} lacks {sorted(missing)}"


def _public_params(path: Path) -> dict:
    """Each public function's and method's parameter names, in order
    (``*args`` and ``**kwargs`` with their stars)."""
    def params(fn):
        a = fn.args
        names = [x.arg for x in a.posonlyargs + a.args]
        names += [f"*{a.vararg.arg}"] if a.vararg else []
        names += [x.arg for x in a.kwonlyargs]
        return names + ([f"**{a.kwarg.arg}"] if a.kwarg else [])

    out = {}
    for node in ast.parse(path.read_text()).body:
        if isinstance(node, ast.FunctionDef) and not node.name.startswith("_"):
            out[node.name] = params(node)
        if isinstance(node, ast.ClassDef) and not node.name.startswith("_"):
            out.update((f"{node.name}.{m.name}", params(m)) for m in node.body
                       if isinstance(m, ast.FunctionDef)
                       and not m.name.startswith("_"))
    return out


_DEVICE = ("device: the port's makers and builders take the torch device "
           "to allocate on; the reference's arrays go where JAX puts them")
_XP = ("xp: the reference's colour helpers serve numpy and jax.numpy; the "
       "port's take tensors only (numpy's colour math is srgb_oetf_np)")
_ROWS = ("rows: the port computes a slice of the image's or the table's "
         "rows, which the ray-sharded frame gives each rank")
_POOLS = ("the reference's compacted material and leaf-attribute pools, "
          "which the port does not keep (ROADMAP.md Queue 1: the frame "
          "reads voxel_attr)")
# Deliberate differences of parameter lists: the port's parameters of
# each such function or method, and why they differ.
PARAMS_DIFFER = {
    "ops/camera.py::camera_settings": (
        ["camera_to_world", "fov", "near", "far", "width", "height",
         "device"], _DEVICE),
    "ops/denoise.py::make_denoiser_state": (
        ["height", "width", "device"], _DEVICE),
    "ops/noise.py::load_blue_noise": (["device"], _DEVICE),
    "ops/reservoir.py::make_reservoirs": (["n", "device"], _DEVICE),
    "ops/sky.py::bake_sky": (["s", "device"], _DEVICE),
    "ops/spatial_hash.py::make_spatial_hash": (
        ["capacity", "device"], _DEVICE),
    "render/pipeline.py::make_frame_state": (
        ["settings", "scene", "device"], _DEVICE),
    "render/scene.py::build_device_scene": (["scene", "device"], _DEVICE),
    "ops/denoise.py::denoise": (
        ["state", "radiance", "hitdist", "depth", "normal", "world_pos",
         "motion", "prev_view_proj", "settings", "rows"], _ROWS),
    "ops/gi_cache.py::refresh_dense_albedo": (
        ["cache", "scene", "rows"], _ROWS),
    **{f"utils/color.py::{name}": ([arg], _XP) for name, arg in (
        ("acescg_to_srgb", "v"), ("acescg_to_xyz", "v"),
        ("luminance_rec601", "rgb"), ("srgb_eotf", "c"), ("srgb_oetf", "c"),
        ("srgb_to_acescg", "v"), ("xyz_to_acescg", "v"))},
    "vox/geometry.py::unpack_r10g10b10a2": (["packed"], _XP),
    "parallel/mesh.py::make_mesh": (
        ["group"], "the mesh is this process's rank of a torch.distributed "
        "group, where the reference's is a jax Mesh over local devices"),
    "parallel/mesh.py::ray_sharding": (
        ["mesh", "length"], "it returns this rank's [start, stop) of an "
        "axis of that length, where the reference's returns a "
        "NamedSharding that needs none"),
    "render/pipeline.py::render_frame": (
        ["scene", "state", "cam", "sky_state", "bn_cosine", "bn_scalar",
         "settings", "tile", "return_aux", "mesh"],
        "mesh in place of ray_sharding: each rank renders its chunk of "
        "the rays on its process group"),
    "render/scene.py::splice_model": (
        ["device", "slot", "geo", "mat_cap", "palette"],
        "no mat_base, and the palette to refill voxel_attr: " + _POOLS),
    "render/scene.py::apply_leaf_patch": (
        ["device", "model", "row", "mask_lo", "mask_hi", "alb", "vox"],
        "no attr, fg, gi_table, gi_rows, gi_alb: " + _POOLS
        + "; the editor patches the GI tables itself"),
}


@pytest.mark.parametrize("path", REF_MODULES)
def test_public_parameters_match_reference(path):
    """Every public function and method that the port and a reference
    module both define takes the reference's parameters, in its order,
    apart from the reasoned differences of PARAMS_DIFFER."""
    ref = _public_params(REPO / "dust_tpu" / path)
    port = _public_params(REPO / "dust_tpu_torch" / path)
    for name in sorted(ref.keys() & port.keys()):
        allowed = PARAMS_DIFFER.get(f"{path}::{name}")
        if allowed is None:
            assert port[name] == ref[name], (
                f"dust_tpu_torch/{path}: {name}{tuple(port[name])}, "
                f"reference {name}{tuple(ref[name])}")
        else:
            assert port[name] == allowed[0] != ref[name], (name, port[name])
    listed = {k.split("::")[1] for k in PARAMS_DIFFER
              if k.startswith(f"{path}::")}
    assert listed <= ref.keys() & port.keys(), listed
