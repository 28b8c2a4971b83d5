"""The port's native libraries (``dust_tpu_torch/csrc``), one case for
each library: the four CUDA sources (``hdda``, ``gbuffer``,
``spatial_hash``, ``denoise``) and, where the case is about the build,
the native scene build's ``voxcore``.

Each is built through one cached build, with its flags (``-fmad=false``
for every CUDA source), once, into ``lib<stem>_<tag>.so``; a missing
compiler raises and leaves nothing; a failed compile raises with the
compiler's message; importing the package builds and loads nothing and
every counter reads zero. The kernels carry the names the benchmark's
device-trace readers select on; the wrappers raise off CUDA; every
ctypes structure and entry-point signature is its source's, member by
member and type by type; and a :class:`csrc.Library` binds, launches on
the device's stream, raises on an error code and counts."""

import contextlib
import ctypes
import hashlib
import json
import os
import re
import subprocess
import sys
import types
from pathlib import Path

import pytest
import torch
from torch_card import chip_smoke

from dust_tpu_torch import config, csrc, native
from dust_tpu_torch.ops import camera as cameralib
from dust_tpu_torch.ops import denoise, gbuffer, hdda
from dust_tpu_torch.ops import spatial_hash as sh

REPO = Path(__file__).resolve().parents[1]
CSRC = REPO / "dust_tpu_torch" / "csrc"
CUDA = {"hdda": hdda, "gbuffer": gbuffer, "spatial_hash": sh,
        "denoise": denoise}
LIBRARIES = [*CUDA, "voxcore"]


def _build(name):
    """(build, source, flags) of the library ``name``."""
    if name == "voxcore":
        return native.build_library, native._SOURCE, native.CXX_FLAGS
    lib = CUDA[name].LIBRARY
    return lib.build, lib.source, csrc.NVCC_FLAGS


def _use_compiler(monkeypatch, name, path):
    if name == "voxcore":
        monkeypatch.setattr(native, "CXX", str(path))
    else:
        monkeypatch.setattr(csrc, "_nvcc", lambda: str(path))


def _script(path, body):
    path.write_text("#!/bin/sh\n" + body)
    path.chmod(0o755)
    return path


# ------------------------------------------------------------ the build

def test_the_cuda_flags():
    """The flags every CUDA library's name is hashed from (unchanged, so
    every library already built is reused)."""
    assert csrc.NVCC_FLAGS == [
        "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
        "-fmad=false", "-shared", "-Xcompiler", "-fPIC"]


@pytest.mark.parametrize("name", LIBRARIES)
def test_built_with_its_flags_once(name, tmp_path, monkeypatch):
    """The compiler runs once, with the library's flags, on its source,
    into ``lib<name>_<sha256(source + flags)[:16]>.so``; a second build
    finds the library and runs nothing."""
    cmds = []

    def fake_run(cmd, **kw):
        cmds.append(cmd)
        return subprocess.CompletedProcess(cmd, 0, "", "")

    monkeypatch.setattr(csrc, "_BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(csrc.subprocess, "run", fake_run)
    compiler = _script(tmp_path / "compiler", "exit 0\n")
    _use_compiler(monkeypatch, name, compiler)
    build, source, flags = _build(name)
    out = build()
    tag = hashlib.sha256(source.read_bytes()
                         + " ".join(flags).encode()).hexdigest()[:16]
    assert out == tmp_path / "build" / f"lib{name}_{tag}.so"
    assert out.exists()
    assert cmds == [[str(compiler), *flags, "-o", cmds[0][-2], str(source)]]
    assert build() == out and len(cmds) == 1
    if name != "voxcore":
        assert source == CSRC / f"{name}.cu"
        assert "-fmad=false" in flags


@pytest.mark.parametrize("name", list(CUDA))
def test_verbose_build_prints_the_ptxas_report(name, tmp_path, monkeypatch,
                                               capsys):
    """``verbose`` compiles a library already built once more, with
    ``-Xptxas -v``, into the same file, and prints the report."""
    cmds = []

    def fake_run(cmd, **kw):
        cmds.append(cmd)
        return subprocess.CompletedProcess(cmd, 0, "", "Used 40 registers\n")

    monkeypatch.setattr(csrc, "_BUILD_DIR", tmp_path)
    monkeypatch.setattr(csrc.subprocess, "run", fake_run)
    _use_compiler(monkeypatch, name, _script(tmp_path / "nvcc", "exit 0\n"))
    lib = CUDA[name].LIBRARY
    out = lib.build()
    assert capsys.readouterr().out == ""
    assert lib.build(verbose=True) == out and len(cmds) == 2
    assert cmds[1][1:len(csrc.NVCC_FLAGS) + 3] == [*csrc.NVCC_FLAGS,
                                                   "-Xptxas", "-v"]
    assert capsys.readouterr().out == "Used 40 registers\n"


@pytest.mark.parametrize("name", LIBRARIES)
def test_no_compiler_raises_and_leaves_nothing(name, tmp_path,
                                               monkeypatch):
    monkeypatch.setattr(csrc, "_BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(csrc.shutil, "which", lambda *a, **k: None)
    compiler = "g++" if name == "voxcore" else "nvcc"
    with pytest.raises(RuntimeError, match=re.escape(f"{compiler} not found")):
        _build(name)[0]()
    assert not (tmp_path / "build").exists()


@pytest.mark.parametrize("name", LIBRARIES)
def test_failed_compile_raises_with_its_message(name, tmp_path,
                                                monkeypatch):
    monkeypatch.setattr(csrc, "_BUILD_DIR", tmp_path / "build")
    _use_compiler(monkeypatch, name, _script(
        tmp_path / "failing", "echo 'source:1: error: no' >&2\nexit 3\n"))
    with pytest.raises(RuntimeError, match="failed \\(3\\)(.|\n)*error: no"):
        _build(name)[0]()
    assert os.listdir(tmp_path / "build") == []


_IMPORT_ALL = """
import importlib, json, pkgutil
import dust_tpu_torch
for m in pkgutil.walk_packages(dust_tpu_torch.__path__, 'dust_tpu_torch.'):
    importlib.import_module(m.name)
from dust_tpu_torch import native
from dust_tpu_torch.ops import denoise, gbuffer, hdda, spatial_hash
maps = open('/proc/self/maps').read()
out = {name: dict(loaded=m.LIBRARY.handle is not None, counters=counters)
       for name, m, counters in (
           ('hdda', hdda, [hdda.LAUNCHES, hdda.INSTANCE_LAUNCHES]),
           ('gbuffer', gbuffer, [gbuffer.LAUNCHES]),
           ('spatial_hash', spatial_hash, [spatial_hash.LAUNCHES]),
           ('denoise', denoise, [denoise.LAUNCHES]))}
out['voxcore'] = dict(loaded=native._LIB is not None, counters=[])
for name in out:
    out[name]['mapped'] = f'/lib{name}_' in maps
print(json.dumps(out))
"""

_MODES = dict.fromkeys(hdda.MODES, 0)
COUNTERS = {
    "hdda": [_MODES, _MODES],
    "gbuffer": [{"primary_rays": 0, "gbuffer_resolve": 0, "gather_dirs": 0,
                 "gather_resolve": 0}],
    "spatial_hash": [{"probe": 0, "keys": 0, "scan_up": 0, "scan_blocks": 0,
                      "scan": 0, "apply": 0, "logluv": 0}],
    "denoise": [{"denoise_temporal": 0, "denoise_atrous": 0}],
    "voxcore": []}


@pytest.fixture(scope="module")
def imported():
    """Every module of the port imported in a fresh process with no
    compiler on the path: each library's state."""
    r = subprocess.run([sys.executable, "-c", _IMPORT_ALL], cwd=REPO,
                       env=dict(os.environ, PYTHONPATH=str(REPO), PATH=""),
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stdout + r.stderr
    return json.loads(r.stdout.splitlines()[-1])


@pytest.mark.parametrize("name", LIBRARIES)
def test_importing_builds_and_loads_nothing(name, imported):
    """Nothing built or loaded (no ``lib<name>_`` mapped), and the
    counters, with their keys, at zero."""
    assert imported[name] == dict(loaded=False, counters=COUNTERS[name],
                                  mapped=False)


# --------------------------------------------------------- the kernels

KERNELS = {
    "hdda": ["hdda_instance_kernel", "hdda_kernel"],
    "gbuffer": ["gather_dirs_kernel", "gather_resolve_kernel",
                "gbuffer_resolve_kernel", "primary_rays_kernel"],
    "spatial_hash": ["spatial_hash_apply_kernel", "spatial_hash_keys_kernel",
                     "spatial_hash_logluv_kernel", "spatial_hash_probe_kernel",
                     "spatial_hash_scan_blocks_kernel",
                     "spatial_hash_scan_kernel",
                     "spatial_hash_scan_up_kernel"],
    "denoise": ["denoise_atrous_kernel", "denoise_temporal_kernel"]}
# The counters' keys, each a kernel's name without this prefix and
# "_kernel" (the HDDA counters count by mode).
COUNTED = {"gbuffer": "", "spatial_hash": "spatial_hash_", "denoise": ""}


@pytest.mark.parametrize("name", list(CUDA))
def test_kernel_names(name):
    """The benchmark counts every kernel whose name holds ``hdda`` as the
    traversal's, and reads ``hash_device_ms`` from ``spatial_hash_`` and
    ``denoise_device_ms`` from ``denoise_``: no kernel outside
    ``hdda.cu`` holds ``hdda`` (nor does its code), and every hash or
    denoise kernel carries its prefix; a counter key for each kernel."""
    src = (CSRC / f"{name}.cu").read_text()
    names = re.findall(r"__global__\s+void\s+"
                       r"(?:__launch_bounds__\([^)]*\)\s+)?(\w+)\s*\(", src)
    assert sorted(names) == KERNELS[name]
    if name == "hdda":
        assert all("hdda" in n for n in names)
        return
    assert "hdda" not in src.split("namespace {", 1)[1].lower()
    if name in ("spatial_hash", "denoise"):
        assert all(n.startswith(name + "_") for n in names)
    assert sorted(f"{COUNTED[name]}{k}_kernel"
                  for k in CUDA[name].LAUNCHES) == KERNELS[name]


def _hdda_args(device, scene=True, n=4):
    """Zero inputs of :func:`hdda.hdda` (one model, one instance), or of
    :func:`hdda.hdda_instance` (that model's tables)."""
    def z(*shape, dtype=torch.float32):
        return torch.zeros(shape, dtype=dtype, device=device)

    i32 = torch.int32
    tables = (z(1, 512, dtype=i32), z(1, 4096, 4, dtype=i32),
              z(1, 1024, 2, dtype=i32))
    rays = (z(n, 3), z(n, 3), z(n), z(n))
    if not scene:
        return (*(t[0] for t in tables), *rays)
    return (*tables, z(1, dtype=i32), z(1, dtype=i32), z(1, 12), z(1, 6),
            *rays)


def _denoise(device):
    """:func:`denoise.denoise`'s inputs: the state and a step's."""
    a = chip_smoke()._denoise_inputs(16, 32, "cpu", 0, False)["a"]
    return dict(state=denoise.make_denoiser_state(16, 32, device),
                settings=config.DenoiserSettings(),
                **{k: v.to(device) for k, v in a.items()})


def _cam():
    return cameralib.camera_settings(
        cameralib.look_at((26.0, 14.0, 32.0), (4.0, -4.0, 0.0)), 0.9, 0.1,
        1e4, 128, 8, "cpu")


_Z = torch.zeros
OFF_CUDA = {
    "hdda.hdda": lambda: hdda.hdda(*_hdda_args("meta"), mode="precise"),
    "hdda.hdda_instance": lambda: hdda.hdda_instance(
        *_hdda_args("meta", scene=False)),
    "gbuffer.rays": lambda: gbuffer.rays(_cam(), 128, 8, True, 0, 1024),
    "gbuffer.resolve": lambda: gbuffer.resolve(None, None, _Z(4, 3),
                                               _Z(4, 3)),
    "gbuffer.dirs": lambda: gbuffer.dirs(
        _Z(4, 3), _Z(4, dtype=torch.bool), _Z(64, 128, 128, 3), 0, (7, 183),
        0, 128, 8, True, 0, 4, 0.5),
    "gbuffer.gather": lambda: gbuffer.gather(
        None, None, None, _Z(4, 3), _Z(4, 3), _Z(4, dtype=torch.bool),
        _Z(4, 3), _Z(4, 3), None, None, True, False, False),
    "spatial_hash.probe": lambda: sh._probe_kernel(
        sh.make_spatial_hash(1 << 8, "cpu"), _Z(4, 3),
        torch.ones(4, dtype=torch.bool), 4.0, _Z(24, dtype=torch.int32),
        None, 0, None),
    "spatial_hash.insert": lambda: sh._insert_kernels(
        sh.make_spatial_hash(1 << 8, "cpu"), _Z(4, 3, dtype=torch.int32),
        _Z(4, dtype=torch.int32), _Z(4, 3), 0, None, None),
    "spatial_hash.logluv": lambda: sh.logluv(_Z(4, dtype=torch.int32)),
    "denoise.denoise": lambda: denoise.denoise(**_denoise("meta")),
    "denoise.kernels": lambda: denoise._denoise_kernels(
        rows=None, **_denoise("cpu")),
}


@pytest.mark.parametrize("call", list(OFF_CUDA))
def test_wrappers_raise_off_cuda(call):
    """Tensors on the CPU (the launch wrappers that the entry points call
    only off the CPU) or on a device that is neither the CPU nor CUDA:
    the wrapper raises; nothing falls back."""
    with pytest.raises(ValueError, match="unsupported device"):
        OFF_CUDA[call]()


# ------------------------------------------------- the bindings, checked

_SCALARS = {"int": ctypes.c_int, "long long": ctypes.c_longlong,
            "float": ctypes.c_float}


def _c_fields(src, struct, module):
    """The members of ``struct`` in ``src`` as (name, ctypes type): a
    pointer as ``c_void_p``, ``T x[n]`` as an array, a struct member as
    the module's structure of that name."""
    body = re.findall(r"\bstruct %s \{(.*?)\n\};" % struct, src, re.S)
    assert len(body) == 1, struct
    fields = []
    for decl in re.sub(r"//[^\n]*", "", body[0]).split(";"):
        decl = " ".join(decl.split())
        if not decl:
            continue
        m = re.fullmatch(r"((?:const )?[\w ]*?\w) ?(\*?) ?"
                         r"(\w+(?:\[\d+\])?(?:, \w+(?:\[\d+\])?)*)", decl)
        assert m, decl
        ctype, pointer, names = m.groups()
        ctype = ctype.removeprefix("const ")
        for declarator in names.split(", "):
            name, count = re.fullmatch(r"(\w+)(?:\[(\d+)\])?",
                                       declarator).groups()
            t = (ctypes.c_void_p if pointer else
                 _SCALARS.get(ctype) or getattr(module, "_" + ctype))
            fields.append((name, t * int(count) if count else t))
    return fields


def _same_type(a, b):
    if issubclass(a, ctypes.Array) and issubclass(b, ctypes.Array):
        return a._type_ is b._type_ and a._length_ == b._length_
    return a is b


STRUCTURES = [("gbuffer", "_RaysArgs"), ("gbuffer", "_SkyArgs"),
              ("gbuffer", "_ResolveArgs"), ("gbuffer", "_GatherDirsArgs"),
              ("gbuffer", "_CacheArgs"), ("gbuffer", "_GatherResolveArgs"),
              ("spatial_hash", "_LogLuv"), ("spatial_hash", "_ProbeArgs"),
              ("spatial_hash", "_InsertArgs"),
              ("spatial_hash", "_LogLuvArgs"),
              ("denoise", "_TemporalArgs"), ("denoise", "_AtrousArgs")]


@pytest.mark.parametrize("name, cls", STRUCTURES,
                         ids=[f"{n}.{c}" for n, c in STRUCTURES])
def test_structure_matches_the_source(name, cls):
    """The ctypes structure lists the source's members in its order, each
    of its type (a pointer for each pointer, ``long long``, ``int``,
    ``float``, ``float[9]`` and nested structures as such)."""
    module = CUDA[name]
    py = getattr(module, cls)._fields_
    c = _c_fields((CSRC / f"{name}.cu").read_text(), cls[1:], module)
    assert [n for n, _ in py] == [n for n, _ in c]
    for (n, a), (_, b) in zip(py, c):
        assert _same_type(a, b), (cls, n, a, b)


@pytest.mark.parametrize("name", list(CUDA))
def test_every_structure_is_checked(name):
    module = CUDA[name]
    found = sorted(k for k, v in vars(module).items()
                   if isinstance(v, type) and issubclass(v, ctypes.Structure)
                   and v.__module__ == module.__name__)
    assert found == sorted(c for n, c in STRUCTURES if n == name)


@pytest.mark.parametrize("name", list(CUDA))
def test_entry_points_match_the_source(name):
    """Every ``extern "C"`` entry point of the source is bound, with one
    argument type for each parameter (a pointer as ``c_void_p``, an
    ``int`` as ``c_int``), the stream last."""
    src = (CSRC / f"{name}.cu").read_text()
    entries = dict(re.findall(r'extern "C" int (\w+)\((.*?)\)', src, re.S))
    lib = CUDA[name].LIBRARY
    assert sorted(lib.entries) == sorted(entries)
    for entry, params in entries.items():
        want = [ctypes.c_void_p if "*" in p else
                _SCALARS[" ".join(p.split()[:-1])]
                for p in params.split(",")]
        assert [*lib.entries[entry][0], ctypes.c_void_p] == want, entry
        assert params.split(",")[-1].split() == ["void*", "stream"], entry


# ------------------------------------------------------------ the Library

_ECHO = """extern "C" int echo(int err, void* stream) {
  return stream == reinterpret_cast<void*>(1234) ? err : -1;
}
"""


def test_library_builds_at_first_launch_raises_and_counts(tmp_path,
                                                          monkeypatch):
    """A :class:`csrc.Library` (here over a C++ entry point built with
    g++) builds and loads at its first launch, not before; passes the
    current stream of the device last; raises on a nonzero return,
    naming the entry and the error, and counts only what launched."""
    source = tmp_path / "echo.cpp"
    source.write_text(_ECHO)
    monkeypatch.setattr(csrc, "_BUILD_DIR", tmp_path / "build")
    counter = {"echo": 0}
    lib = csrc.Library(source, "echo", {"echo": ([ctypes.c_int], counter)})
    monkeypatch.setattr(lib, "build", lambda verbose=False: csrc.build(
        source, "echo", "g++", ["-shared", "-fPIC"]))
    monkeypatch.setattr(torch.cuda, "device",
                        lambda device: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda device: types.SimpleNamespace(cuda_stream=1234))
    assert lib.source == source and lib.handle is None
    assert not (tmp_path / "build").exists()
    lib.launch("echo", 0, device=torch.device("cpu"), count="echo")
    handle = lib.handle
    assert handle is not None and counter == {"echo": 1}
    with pytest.raises(RuntimeError, match="echo failed: CUDA error 7"):
        lib.launch("echo", 7, device=torch.device("cpu"), count="echo")
    assert counter == {"echo": 1} and lib.handle is handle
    assert len(list((tmp_path / "build").iterdir())) == 1


@pytest.mark.parametrize("bad, error, match", [
    (torch.zeros(4, 3, dtype=torch.float64), TypeError, "expected"),
    (torch.zeros(5, 3), ValueError, "shape"),
    (torch.zeros(3, 4).t(), ValueError, "contiguous"),
    (torch.zeros(4, 3, device="meta"), ValueError, "on meta")])
def test_check(bad, error, match):
    good = torch.zeros(4, 3)
    assert csrc.check("x", good, torch.float32, (4, 3), good.device) is good
    with pytest.raises(error, match=match):
        csrc.check("x", bad, torch.float32, (4, 3), torch.device("cpu"))


def test_on_cuda_and_f32_recip():
    with pytest.raises(ValueError, match="unsupported device cpu"):
        csrc.on_cuda("k", torch.device("cpu"), 4, "rays")
    with pytest.raises(ValueError, match="2147483648 keys"):
        csrc.on_cuda("k", torch.device("cuda"), 2 ** 31, "keys")
    csrc.on_cuda("k", torch.device("cuda"), 2 ** 31 - 1, "keys")
    assert csrc.f32_recip(3.0) == float(torch.tensor(1 / 3.0))
    assert csrc.f32_recip(255.0) != 1 / 255.0
