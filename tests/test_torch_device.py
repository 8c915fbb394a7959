"""The device rule of the port's scene factories: the card unless the caller
asks for the CPU.

Every scene factory and scene carry-over function of ``models/`` takes
``device=None``, which means ``'cuda'`` (``device.resolve_device``).
Without CUDA a call without ``device`` raises and names ``device='cpu'``;
with ``device='cpu'`` it returns what it returned when the CPU was its
default, bit for bit (``CPU_DIGESTS``: a digest of every tensor's dtype,
shape and bytes, taken from the factories before the default moved). On
a card (``-m cuda``; the file imports no JAX, so ``--noconftest`` runs
it there) a default scene lands on ``cuda:0``, and ``render_kernel`` and
``render_stream`` launch kernels 1 and 4 on it.
"""
import hashlib

import numpy as np
import pytest
import torch

from raytracingincuda_torch.models import convert, io, reference_scene
from raytracingincuda_torch.models import scene as tscene
from raytracingincuda_torch.models.camera import CameraConfig
from raytracingincuda_torch.models.scene import param_leaves
from raytracingincuda_torch.ops import render_kernel as rk
from raytracingincuda_torch.ops import stream_kernel as sk

torch.set_num_threads(1)


def _scene_leaves() -> list:
    """The 11 leaves of scene 2 as host numpy: a JAX Scene's layout."""
    s = tscene.build_scene(2, pad_to_multiple=64, device="cpu")
    return [t.numpy() for t in (*param_leaves(s.params), s.mat_type,
                                s.active)]


def _train_leaves() -> list:
    """An Adam TrainState's 29 leaves: 9 params, count, 9 mu, 9 nu, step."""
    params = _scene_leaves()[:9]
    rng = np.random.default_rng(5)
    mu = [rng.standard_normal(p.shape).astype(np.float32) for p in params]
    nu = [rng.random(p.shape).astype(np.float32) for p in params]
    return [*params, np.int32(3), *mu, *nu, np.int32(3)]


def _f64_inputs() -> tuple:
    rng = np.random.default_rng(6)
    hi = rng.standard_normal((24, 16)).astype(np.float32)
    rows = rng.standard_normal((2, 24)).astype(np.float32)
    return hi, np.zeros_like(hi), rows


def _stream_arrays() -> tuple:
    rng = np.random.default_rng(7)
    return (rng.standard_normal((32, 16)).astype(np.float32),
            rng.standard_normal((4, 8)).astype(np.float32), 8,
            rng.permutation(30).astype(np.int32))


def _load(path_dir, **kw):
    path = str(path_dir / "scene.npz")
    io.save_scene(path, tscene.build_scene(3, device="cpu"))
    return io.load_scene(path, **kw)


# name -> f(tmp_path, **device keyword) for every repaired factory
FACTORIES = {
    "build_scene": lambda p, **kw: tscene.build_scene(1, **kw),
    "build_random_scene": lambda p, **kw: tscene.build_random_scene(
        300, seed=4, **kw),
    "build_deep_scene": lambda p, **kw: tscene.build_deep_scene(**kw),
    "build_serial_reference_scene":
        lambda p, **kw: reference_scene.build_serial_reference_scene(**kw),
    "scene_from_arrays": lambda p, **kw: io.scene_from_arrays(
        [[0, 0, -1], [1, 0, -1]], [0.5, 0.25], [0, 2], ior=[1.0, 1.5],
        pad_to_multiple=8, **kw),
    "load_scene": lambda p, **kw: _load(p, **kw),
    "scene_from_numpy": lambda p, **kw: convert.scene_from_numpy(
        _scene_leaves(), **kw),
    "f64_inputs_from_numpy": lambda p, **kw: convert.f64_inputs_from_numpy(
        *_f64_inputs(), **kw),
    "train_state_from_numpy":
        lambda p, **kw: convert.train_state_from_numpy(_train_leaves(), **kw),
    "stream_scene_from_numpy":
        lambda p, **kw: convert.stream_scene_from_numpy(*_stream_arrays(),
                                                        **kw),
}

# digest() of each factory's result with device='cpu', taken before the
# default moved to the card (when 'cpu' was the default)
CPU_DIGESTS = {
    "build_deep_scene":
        "d5b1ef6699ec6b972017902de75882ff79ed79d8dd8bbf6598268b740f389d0c",
    "build_random_scene":
        "b932088fed267b90de5fb899114a5a88a40187460e30851d0dae1c4d7876073e",
    "build_scene":
        "0d8169d12d1b65b59bdf5f5adae3bec2dbbb76e26d815547c0ff6a79d9f2f449",
    "build_serial_reference_scene":
        "5b379cb1daef197e9ed58a6b3527e958772528061980caea48c4d1ec07861788",
    "f64_inputs_from_numpy":
        "2f6f0426cc8dd7bd5f1b2dd1d14bec8c07d00e0e08376ac4ee9879a8a49932ae",
    "load_scene":
        "ac42a8924e3e92df990f935d4201b38428c86215f75a2794bc3df2b23840f80a",
    "scene_from_arrays":
        "71b618639ba2e932f2bc336f5fd5a1e0bd6e54aa53aede487649a1a268bf2aa4",
    "scene_from_numpy":
        "947672468ebbda1c36687d9173d37732e7460a513615a5739e58c4d81f914266",
    "stream_scene_from_numpy":
        "4bfc84d2e3143b58c2212e2533a74eb4dc6c49cc70894cb3d2042e88133702ed",
    "train_state_from_numpy":
        "9de309f2c4d55e14cc7642e8c47a5bcb11a99eb724a0d2c403477778678d68ee",
}


def tensors(obj) -> list:
    """Every tensor in a result, depth first in field order."""
    if isinstance(obj, torch.Tensor):
        return [obj]
    if isinstance(obj, tuple):
        return [t for o in obj for t in tensors(o)]
    return []


def digest(obj) -> str:
    h = hashlib.sha256()
    for t in tensors(obj):
        h.update(f"{t.dtype} {tuple(t.shape)}".encode())
        h.update(t.detach().cpu().contiguous().numpy().tobytes())
    return h.hexdigest()


@pytest.mark.parametrize("name", sorted(FACTORIES))
def test_default_device_raises_without_cuda(name, tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        FACTORIES[name](tmp_path)


@pytest.mark.parametrize("name", sorted(FACTORIES))
def test_cpu_device_is_bit_equal_to_the_old_default(name, tmp_path):
    got = FACTORIES[name](tmp_path, device="cpu")
    assert tensors(got) and all(t.device.type == "cpu" for t in tensors(got))
    assert digest(got) == CPU_DIGESTS[name]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: run `pytest -m cuda` on the GPU")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("name", sorted(FACTORIES))
def test_default_lands_on_the_card(cuda, name, tmp_path):
    got = FACTORIES[name](tmp_path)
    assert all(t.device == torch.device("cuda", 0) for t in tensors(got))
    assert digest(got) == CPU_DIGESTS[name]


@pytest.mark.cuda
def test_default_scenes_render_on_the_kernels(cuda):
    """render_kernel on a default scene launches kernel 1, and
    render_stream on a default stream scene kernel 4: not the plain
    versions."""
    cam = CameraConfig.reference_default()
    before = rk.LAUNCHES
    img = rk.render_kernel(tscene.build_scene(1), cam, 64, 40, 2, 8)
    torch.cuda.synchronize()
    assert rk.LAUNCHES > before and img.is_cuda
    stream = sk.prepare_stream_scene(tscene.build_random_scene(2000, seed=3))
    before = sk.LAUNCHES
    img = sk.render_stream(stream, cam, 64, 40, 2, 8)
    torch.cuda.synchronize()
    assert sk.LAUNCHES > before and img.is_cuda
