"""The last module slice against the JAX package (CPU): the video, stream,
screenshot and classification loaders of ``data/loaders.py``, ``wiou`` and
``xywhn2xyxy`` of ``ops/boxes.py``, and ``Profile``, ``Timeout``,
``colorstr`` and ``select_device`` of ``utils/general.py``; with them the
JAX-only names the port has since (``native.is_available``), and the clips
``chip_smoke.py``'s phase ``loaders`` serves on the card.

Inputs are made from a seed with numpy and written with PIL into
``tmp_path``.  Frames, letterboxed arrays and dataset items are compared bit
for bit; the box functions in float64 to 1e-12 and in float32 to 1e-6
against JAX under ``jax.enable_x64()``.  Video is decoded through imageio as
in JAX, and again through the port's Pillow route (imageio's import made to
fail), which must give the same frames.
"""

import signal
import sys
import threading
import time

import jax
import numpy as np
import pytest
import torch
from PIL import Image

import chip_smoke
from ecs_yolo_tpu import native as jax_native
from ecs_yolo_tpu.data import loaders as JL
from ecs_yolo_tpu.ops import boxes as JBX
from ecs_yolo_tpu.utils import general as JG
from ecs_yolo_tpu_torch import native as port_native
from ecs_yolo_tpu_torch.data import loaders as PL
from ecs_yolo_tpu_torch.data.augment import letterbox
from ecs_yolo_tpu_torch.ops import boxes as PBX
from ecs_yolo_tpu_torch.utils import general as PG

STREAM_DEADLINE_S = 5.0
#: XLA's cheap compile: the JAX box functions run once
_FAST = dict(xla_backend_optimization_level=0, xla_llvm_disable_expensive_passes=True)


def write_gif(path, frames: int, hw, seed: int):
    """An animated GIF of ``frames`` frames of size ``hw``: a flat
    background with two filled rectangles moving across it."""
    rng = np.random.RandomState(seed)
    h, w = hw
    bg, colours = rng.randint(0, 255, 3), rng.randint(0, 255, (2, 3))
    starts, steps = rng.randint(0, min(h, w) // 2, (2, 2)), rng.randint(1, 5, (2, 2))
    ims = []
    for f in range(frames):
        im = np.empty((h, w, 3), np.uint8)
        im[:] = bg
        for (y, x), (dy, dx), c in zip(starts, steps, colours):
            y0, x0 = (y + f * dy) % (h - 8), (x + f * dx) % (w - 8)
            im[y0:y0 + h // 3, x0:x0 + w // 4] = c
        ims.append(Image.fromarray(im))
    ims[0].save(path, save_all=True, append_images=ims[1:], duration=40, loop=0)
    return path


def _without_imageio(monkeypatch):
    """Make ``import imageio`` fail, as on a machine without it."""
    monkeypatch.setitem(sys.modules, "imageio", None)
    monkeypatch.setitem(sys.modules, "imageio.v3", None)


def _assert_items_equal(got, want):
    assert len(got) == len(want)
    for (gn, gi, g0), (wn, wi, w0) in zip(got, want):
        assert gn == wn
        assert gi.dtype == wi.dtype == np.float32 and np.array_equal(gi, wi)
        if isinstance(w0, list):
            assert len(g0) == len(w0) and all(np.array_equal(a, b) for a, b in zip(g0, w0))
        else:
            assert np.array_equal(g0, w0)


# --- video -------------------------------------------------------------------------


@pytest.mark.parametrize("route", ["imageio", "pillow"])
@pytest.mark.parametrize("vid_stride", [1, 3])
def test_load_video_equals_jax(tmp_path, monkeypatch, route, vid_stride):
    path = write_gif(tmp_path / "clip.gif", 8, (64, 96), seed=1)
    want = list(JL.LoadVideo(path, img_size=64, vid_stride=vid_stride))
    assert len(want) == len(range(0, 8, vid_stride))
    if route == "pillow":
        _without_imageio(monkeypatch)
        with pytest.raises(ImportError, match="imageio"):
            PL.LoadVideo(tmp_path / "clip.mp4", img_size=64)
    got = list(PL.LoadVideo(path, img_size=64, vid_stride=vid_stride))
    _assert_items_equal(got, want)
    assert got[0][1].shape == (1, 64, 64, 3) and got[0][2].shape == (64, 96, 3)


def test_smoke_clips_decode_alike_on_both_routes(tmp_path, monkeypatch):
    """The card machine has no imageio: ``chip_smoke.write_clips``'s GIFs
    read through Pillow give JAX's (imageio's) frames, moving from frame to
    frame."""
    clips = chip_smoke.write_clips(tmp_path, 0)
    want = [list(JL.LoadVideo(c, img_size=64)) for c in clips]
    _without_imageio(monkeypatch)
    for c, w in zip(clips, want):
        got = list(PL.LoadVideo(c, img_size=64))
        _assert_items_equal(got, w)
        assert len(got) == chip_smoke.LOADER_FRAMES
        assert got[0][2].shape == (*chip_smoke.LOADER_HW, 3)
        assert not np.array_equal(got[0][2], got[1][2])


# --- streams -----------------------------------------------------------------------


def _drain(streams):
    """Every batch of ``streams`` within the deadline, then closed."""
    batches, t0 = [], time.perf_counter()
    try:
        for batch in streams:
            batches.append(batch)
            if time.perf_counter() - t0 > STREAM_DEADLINE_S:
                raise AssertionError("the stream did not end within the deadline")
    finally:
        streams.close()
    return batches


@pytest.mark.parametrize("route", ["imageio", "pillow"])
def test_load_streams_over_two_files_ends_on_their_last_frames(tmp_path, monkeypatch, route):
    """Every batch holds, for each source, one of its frames letterboxed;
    the last batch is JAX's last batch (each source's last frame); the
    readers have ended once ``close()`` returns."""
    srcs = [str(write_gif(tmp_path / "a.gif", 8, (64, 96), seed=2)),
            str(write_gif(tmp_path / "b.gif", 5, (80, 48), seed=3))]
    want = _drain(JL.LoadStreams(srcs, img_size=64))
    frames = [[f for _, _, f in JL.LoadVideo(s)] for s in srcs]
    if route == "pillow":
        _without_imageio(monkeypatch)
    streams = PL.LoadStreams(srcs, img_size=64)
    got = _drain(streams)
    assert not any(t.is_alive() for t in streams.threads)
    assert got
    for sources, ims, ims0 in got:
        assert sources == srcs and ims.shape == (2, 64, 64, 3) and ims.dtype == np.float32
        for k, im0 in enumerate(ims0):
            assert any(np.array_equal(im0, f) for f in frames[k])
            lb = letterbox(im0, 64, stride=32, auto=False)[0].astype(np.float32) / 255.0
            assert np.array_equal(ims[k], lb)
    _assert_items_equal(got[-1:], want[-1:])
    assert all(np.array_equal(a, f[-1]) for a, f in zip(got[-1][2], frames))


def test_load_streams_reads_a_txt_list_and_close_stops_a_source(tmp_path):
    src = str(write_gif(tmp_path / "a.gif", 8, (64, 96), seed=4))
    (tmp_path / "list.txt").write_text(src + "\n" + src + "\n")
    streams = PL.LoadStreams(tmp_path / "list.txt", img_size=64)
    assert streams.sources == [src, src]
    streams.close()
    assert not streams.running and not any(t.is_alive() for t in streams.threads)
    assert list(streams) == []


# --- classification ----------------------------------------------------------------


def test_classification_dataset_equals_jax(tmp_path):
    rng = np.random.RandomState(5)
    for ci, cname in enumerate(["cat", "bus", "apple"]):
        (tmp_path / cname).mkdir()
        for j in range(2 + ci):
            h, w = rng.randint(20, 60, 2)
            Image.fromarray((rng.rand(h, w, 3) * 255).astype(np.uint8)).save(
                tmp_path / cname / f"{j}.{'png' if j % 2 else 'jpg'}")
        (tmp_path / cname / "notes.txt").write_text("not an image")
    want, got = JL.ClassificationDataset(tmp_path, 24), PL.ClassificationDataset(tmp_path, 24)
    assert got.classes == want.classes == ["apple", "bus", "cat"]
    assert got.samples == want.samples and len(got) == 9
    for i in range(len(got)):
        (gi, gc), (wi, wc) = got[i], want[i]
        assert gc == wc and gi.dtype == np.float32 and np.array_equal(gi, wi)
    for shuffle in (False, True):
        g = list(got.batches(2, shuffle=shuffle, seed=3))
        w = list(want.batches(2, shuffle=shuffle, seed=3))
        assert len(g) == len(w) == 4
        for (gi, gc), (wi, wc) in zip(g, w):
            assert np.array_equal(gi, wi) and np.array_equal(gc, wc)
    (tmp_path / "empty" / "none").mkdir(parents=True)
    with pytest.raises(FileNotFoundError):
        PL.ClassificationDataset(tmp_path / "empty")


# --- screenshots -------------------------------------------------------------------


@pytest.mark.parametrize("source", ["screen 0 8 16 64 32", "screen 2", "screen 5 10 100 200",
                                    "screen"])
def test_screenshot_source_parses_as_jax(source):
    assert PL.LoadScreenshots.parse_source(source) == JL.LoadScreenshots.parse_source(source)


def test_screenshots_without_mss_raise_jax_hint(monkeypatch):
    monkeypatch.setitem(sys.modules, "mss", None)
    with pytest.raises(ImportError) as want:
        JL.LoadScreenshots("screen 0")
    with pytest.raises(ImportError) as got:
        PL.LoadScreenshots("screen 0")
    assert str(got.value) == str(want.value) and "mss" in str(got.value)


# --- boxes -------------------------------------------------------------------------


def _boxes(rng, n, xywh):
    xy = rng.uniform(0, 50, (n, 2))
    wh = rng.uniform(1, 30, (n, 2))
    return np.concatenate([xy, wh] if xywh else [xy, xy + wh], -1)


@pytest.mark.parametrize("dtype,tol", [(np.float64, 1e-12), (np.float32, 1e-6)],
                         ids=["f64", "f32"])
@pytest.mark.parametrize("case", ["wiou_xywh", "wiou_xyxy", "xywhn2xyxy"])
def test_box_functions_match_jax(case, dtype, tol):
    rng = np.random.RandomState(6)
    xywh = case != "wiou_xyxy"
    b1, b2 = _boxes(rng, 7, xywh).astype(dtype), _boxes(rng, 7, xywh).astype(dtype)
    b2[0] = b1[0]                       # one pair that coincides: penalty 1
    with jax.enable_x64():
        if case == "xywhn2xyxy":
            n = (b1 / 64).astype(dtype)
            want = [jax.jit(lambda a: JBX.xywhn2xyxy(a, w=320, h=256, padw=3, padh=5),
                            compiler_options=_FAST)(n)]
            got = [PBX.xywhn2xyxy(torch.from_numpy(n), w=320, h=256, padw=3, padh=5)]
        else:
            want = jax.jit(lambda a, b: JBX.wiou(a, b, xywh=xywh),
                           compiler_options=_FAST)(b1, b2)
            got = PBX.wiou(torch.from_numpy(b1), torch.from_numpy(b2), xywh=xywh)
        want = [np.array(w) for w in want]
    for g, w in zip(got, want):
        assert g.dtype == torch.from_numpy(w).dtype and g.shape == w.shape
        np.testing.assert_allclose(g.numpy(), w, rtol=tol, atol=tol)
    if case != "xywhn2xyxy":
        assert got[1][0] == 1.0 and bool((got[1] >= 1).all())


# --- general -----------------------------------------------------------------------


def test_timeout_sets_clears_and_suppresses_its_alarm():
    with PG.Timeout(30, timeout_msg="slow") as t:
        assert signal.getitimer(signal.ITIMER_REAL)[0] > 0
        t._handler(signal.SIGALRM, None)          # what the alarm does when it fires
    assert signal.getitimer(signal.ITIMER_REAL)[0] == 0
    with pytest.raises(TimeoutError, match="slow"):
        with PG.Timeout(30, timeout_msg="slow", suppress=False) as t:
            t._handler(signal.SIGALRM, None)
    assert signal.getitimer(signal.ITIMER_REAL)[0] == 0


def test_timeout_off_the_main_thread_is_a_no_op():
    seen = []

    def body():
        with PG.Timeout(30):
            seen.append(signal.getitimer(signal.ITIMER_REAL)[0])

    th = threading.Thread(target=body)
    th.start()
    th.join()
    assert seen == [0.0]


@pytest.mark.parametrize("args", [("x",), ("blue", "bold", "run"), ("red", 3),
                                  ("nope", "underline", "y")])
def test_colorstr_equals_jax(args):
    assert PG.colorstr(*args) == JG.colorstr(*args)


def test_profile_accumulates_host_seconds():
    p = PG.Profile()
    assert p.t == 0.0
    for _ in range(2):
        with p:
            time.sleep(0.01)
    assert p.dt >= 0.01 and p.t >= 0.02 and p.t >= p.dt


def test_select_device_takes_the_card_or_the_cpu_when_asked(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        PG.select_device("")
    with pytest.raises(RuntimeError, match="CUDA"):
        PG.select_device("0")
    assert PG.select_device("cpu") == [torch.device("cpu")]
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)
    assert PG.select_device("") == [torch.device("cuda", 0), torch.device("cuda", 1)]
    assert PG.select_device("1") == PG.select_device("cuda:1") == [torch.device("cuda", 1)]


def test_native_is_available_as_in_jax():
    assert port_native.is_available() is jax_native.is_available() is True
