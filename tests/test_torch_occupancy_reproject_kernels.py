"""The frame paths' two small kernels from the CPU's side: the 8³ mip
(``ops.occupancy.occupancy_mip`` → ``coarse_occupancy_cuda``,
``csrc/coarse_occupancy.cu``) and the moved frame's reprojection
(``renderer_fast.reproject_history_cuda``, the moved mode of
``csrc/compose.cu``).

On the CPU the frame paths take the plain twins; the wrappers refuse a CPU,
wrong-dtype, wrong-shape or misaligned operand with ``ValueError`` before the
kernel library is loaded.  No JAX: ``tests/test_torch_ca_step.py`` holds
``coarse_occupancy`` and ``tests/test_torch_camera.py`` ``reproject_history``
against the JAX package; ``tests/test_torch_cuda.py`` holds the kernels
against the twins on the card.
"""

import numpy as np
import pytest
import torch

import cellularautomatons3d_tpu_torch as ct
from cellularautomatons3d_tpu_torch import kernels
from cellularautomatons3d_tpu_torch.ops import occupancy
from cellularautomatons3d_tpu_torch.ops.occupancy import (
    coarse_occupancy, coarse_occupancy_cuda, occupancy_mip)
from cellularautomatons3d_tpu_torch.render import renderer_fast
from cellularautomatons3d_tpu_torch.render.renderer_fast import (
    FastHistory, reproject_history_cuda)

W, H = 64, 32


class OnCard:
    """A CPU tensor that reports itself on the card, ``offset`` bytes past
    its address: what ``kernels.require`` reads of an operand."""

    device = torch.device("cuda", 0)

    def __init__(self, t, offset=0):
        self.t, self.offset = t, offset
        self.dtype, self.shape = t.dtype, t.shape

    def is_contiguous(self):
        return self.t.is_contiguous()

    def data_ptr(self):
        return self.t.data_ptr() + self.offset

    def element_size(self):
        return self.t.element_size()


@pytest.fixture
def no_library(monkeypatch):
    """Fail the test if anything loads the kernel library."""
    def refuse():
        raise AssertionError("the kernel library was loaded")

    monkeypatch.setattr(kernels, "library", refuse)


@pytest.mark.parametrize("n", [32, 64, 288])
def test_occupancy_mip_on_cpu_is_the_twin(monkeypatch, n):
    """A CPU volume's mip is ``coarse_occupancy``'s, without the kernel."""
    rng = np.random.default_rng(n)
    dense = (rng.random((n, n, n)) < 0.003).astype(np.uint8)
    vol = ct.from_reference(ct.pack_grid(dense), device="cpu")
    before = coarse_occupancy_cuda.launches
    monkeypatch.setattr(occupancy, "coarse_occupancy_cuda", None)  # not called
    got = occupancy_mip(vol)
    assert torch.equal(got, coarse_occupancy(vol))
    assert int((got != 0).sum()) > 0
    assert coarse_occupancy_cuda.launches == before


def test_moved_frame_on_cpu_goes_through_the_twin(monkeypatch):
    """render_frame_fast(camera_static=False) on the CPU calls the twin once
    and its frame is the twin's blend (plus the light cube and gamma); the
    kernel's wrapper is never reached."""
    eng = ct.Engine(device="cpu", grid_size=32, width=W, height=H)
    eng.step(12)
    eng.render()
    eng.camera.translate((1, 0, -1), 0.05)
    eng.camera.mouse_look(6.0, -2.0)
    calls = []
    twin = renderer_fast.reproject_history

    def spy(*args, **kw):
        calls.append(twin(*args, **kw))
        return calls[-1]

    def refuse(*args, **kw):
        raise AssertionError("the kernel's wrapper was called on the CPU")

    monkeypatch.setattr(renderer_fast, "reproject_history", spy)
    monkeypatch.setattr(renderer_fast, "reproject_history_cuda", refuse)
    before = reproject_history_cuda.launches
    history = eng.history
    frame, _, new = renderer_fast.render_frame_fast(
        eng.render_static, eng.state, eng.render_params(), history, camera_static=False)
    assert len(calls) == 1 and reproject_history_cuda.launches == before
    out, src, valid = calls[0]
    assert int(valid.sum()) > 0 and tuple(frame.shape) == (H, W, 3)
    # The history keeps the blend, save where the light cube paints black.
    painted = (out == 0.0).all(-1, keepdim=True) & (new.color == 1.0)
    assert torch.equal(new.color, torch.where(painted, 1.0, out).to(torch.float16))
    # Unchanged: the same call again gives the same frame.
    again = renderer_fast.render_frame_fast(
        eng.render_static, eng.state, eng.render_params(), history, camera_static=False)
    assert torch.equal(again[0], frame) and torch.equal(again[2].color, new.color)


def _mip_operands(n=64):
    return torch.zeros((n // 32, n, n), dtype=torch.int32)


@pytest.mark.parametrize("case,match", [
    ("cpu", "CUDA tensor"),
    ("dtype", "torch.int32"),
    ("shape", "shape"),
    ("strided", "contiguous"),
    ("misaligned", "16-byte aligned"),
])
def test_coarse_occupancy_cuda_rejects(no_library, case, match):
    t = _mip_operands()
    bad = {
        "cpu": t,
        "dtype": OnCard(t.to(torch.int64)),
        "shape": OnCard(torch.zeros((3, 64, 64), dtype=torch.int32)),
        "strided": OnCard(torch.zeros((2, 64, 128), dtype=torch.int32)[..., ::2]),
        "misaligned": OnCard(t, offset=4),
    }[case]
    with pytest.raises(ValueError, match=match):
        coarse_occupancy_cuda(bad)
    if case != "cpu":  # the frame paths' helper takes the kernel for the card
        with pytest.raises(ValueError, match=match):
            occupancy_mip(bad)


def _reprojection_operands():
    return dict(
        color=torch.zeros((H, W, 3), dtype=torch.float16),
        hit_idx=torch.zeros((H, W), dtype=torch.int32),
        rgb=torch.zeros((H, W, 3), dtype=torch.float32),
        depth=torch.zeros((H, W), dtype=torch.float32),
        idx=torch.zeros((H, W), dtype=torch.int32),
    )


@pytest.mark.parametrize("name", ["color", "hit_idx", "rgb", "depth", "idx"])
@pytest.mark.parametrize("case,match", [
    ("cpu", "CUDA tensor"),
    ("dtype", "must be torch"),
    ("shape", "shape"),
    ("misaligned", "aligned"),
])
def test_reproject_history_cuda_rejects(no_library, name, case, match):
    ops = {k: OnCard(v) for k, v in _reprojection_operands().items()}
    t = ops[name].t
    ops[name] = {
        "cpu": t,
        "dtype": OnCard(t.to(torch.float64 if t.is_floating_point() else torch.int64)),
        "shape": OnCard(t[:-1].contiguous()),
        "misaligned": OnCard(t, offset=1),
    }[case]
    params = ct.Engine(device="cpu", grid_size=32, width=W, height=H).render_params()
    hist = FastHistory(ops.pop("color"), ops.pop("hit_idx"))
    with pytest.raises(ValueError, match=match):
        reproject_history_cuda(hist, ops["rgb"], ops["depth"], ops["idx"], params, W, H)


def test_reproject_history_cuda_rejects_rows_outside_the_window(no_library):
    ops = {k: OnCard(v) for k, v in _reprojection_operands().items()}
    params = ct.Engine(device="cpu", grid_size=32, width=W, height=H).render_params()
    hist = FastHistory(ops.pop("color"), ops.pop("hit_idx"))
    with pytest.raises(ValueError, match="do not fit"):
        reproject_history_cuda(hist, *ops.values(), params, W, H, full_height=H + 8, row0=16)
