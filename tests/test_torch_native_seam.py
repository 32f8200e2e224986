"""The port's native seam (``audioflux_torch/ops/_build.py``) on the CPU:
:func:`launch` with a fake C entry, the card's stream getter, device guard
and ``require_sm90`` replaced (its error, its once-a-card check, the
stream as the last argument, the guard only off the current card); the
build's library paths and cache; a source scan that finds no other module
of the port fetching a stream, checking the card or raising a launch
failure; and the row route's refusal of the cut it no longer has."""

import ast
import contextlib
import glob
import os

import pytest
import torch

from audioflux_torch.ops import _build, cuda_fft

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture
def card(monkeypatch):
    """A card stand-in: ``checks`` counts ``require_sm90`` by card index,
    ``guards`` lists the indices a device guard was opened on, stream i
    is 1000 + i, and the current card is 0."""
    state = {"checks": {}, "guards": []}

    def require_sm90(device):
        state["checks"][device.index] = state["checks"].get(device.index,
                                                            0) + 1

    @contextlib.contextmanager
    def guard(index):
        state["guards"].append(index)
        yield

    monkeypatch.setattr(_build, "require_sm90", require_sm90)
    monkeypatch.setattr(_build, "_LAUNCHED", set())
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)
    monkeypatch.setattr(torch.cuda, "device", guard)
    monkeypatch.setattr(torch._C, "_cuda_getCurrentRawStream",
                        lambda index: 1000 + index, raising=False)
    return state


class FakeEntry:
    """A kernel's C entry: records its arguments, returns ``err``."""

    def __init__(self, err=0):
        self.err = err
        self.calls = []

    def __call__(self, *args):
        self.calls.append(args)
        return self.err


@pytest.mark.parametrize("err", [1, 98, 700])
def test_a_nonzero_return_raises_naming_who_and_the_error(card, err):
    with pytest.raises(RuntimeError,
                       match=f"^fft_pow2 forward launch failed: CUDA error "
                             f"{err}$"):
        _build.launch(FakeEntry(err), "fft_pow2 forward",
                      torch.device("cuda", 0), 1, 2)


def test_a_zero_return_passes(card):
    fn = FakeEntry()
    assert _build.launch(fn, "hpss_resynth", torch.device("cuda", 0)) is None
    assert len(fn.calls) == 1


def test_sm90_checked_once_a_card_over_many_launches(card):
    fn = FakeEntry()
    for i in range(50):
        _build.launch(fn, "median_filter", torch.device("cuda", i % 2), i)
    assert card["checks"] == {0: 1, 1: 1}
    assert len(fn.calls) == 50


def test_a_failed_check_is_made_again_at_the_next_launch(card, monkeypatch):
    def refuse(device):
        card["checks"][device.index] = card["checks"].get(device.index,
                                                          0) + 1
        raise RuntimeError("the CUDA kernels need an sm_90 (Hopper) card")

    monkeypatch.setattr(_build, "require_sm90", refuse)
    fn = FakeEntry()
    for _ in range(3):
        with pytest.raises(RuntimeError, match="sm_90"):
            _build.launch(fn, "unwrap_diff", torch.device("cuda", 0))
    assert card["checks"] == {0: 3} and fn.calls == []


@pytest.mark.parametrize("args", [(), (7,), (11, None, 2.5, 3)])
@pytest.mark.parametrize("index", [0, 1])
def test_the_stream_is_the_last_argument(card, args, index):
    fn = FakeEntry()
    _build.launch(fn, "synsq_bins", torch.device("cuda", index), *args)
    assert fn.calls == [(*args, 1000 + index)]


def test_the_guard_opens_only_off_the_current_card(card):
    fn = FakeEntry()
    for index in (0, 0, 1, 0, 2):
        _build.launch(fn, "columnar_scatter", torch.device("cuda", index))
    assert card["guards"] == [1, 2]


def test_every_library_lies_under_the_build_dir():
    paths = [_build.library_path(name)
             for name in (*_build.SOURCES, *_build.HOST)]
    assert len(set(paths)) == len(paths)
    for name, path in zip((*_build.SOURCES, *_build.HOST), paths):
        assert path.parent == _build.BUILD_DIR
        assert path.name.startswith(f"{name}-") and path.suffix == ".so"


def test_the_hash_covers_the_flags(monkeypatch):
    before = _build.library_path("libafpp")
    source, flags = _build.HOST["libafpp"]
    monkeypatch.setitem(_build.HOST, "libafpp", (source, [*flags, "-g"]))
    assert _build.library_path("libafpp") != before
    cuda = _build.library_path("fft_pow2")
    monkeypatch.setattr(_build, "FLAGS", [*_build.FLAGS, "-lineinfo"])
    assert _build.library_path("fft_pow2") != cuda


def test_load_builds_and_hashes_once_a_library(tmp_path, monkeypatch):
    """A library is hashed, built and opened once a process; later loads
    are a dictionary lookup."""
    seen = {"hash": 0, "build": [], "open": []}
    path = tmp_path / "libx-0.so"

    def library_path(name):
        seen["hash"] += 1
        return path

    def build(names):
        seen["build"].append(list(names))
        path.write_bytes(b"")

    def cdll(p):
        seen["open"].append(p)
        return object()

    monkeypatch.setattr(_build, "_libs", {})
    monkeypatch.setattr(_build, "library_path", library_path)
    monkeypatch.setattr(_build, "build", build)
    monkeypatch.setattr(_build.ctypes, "CDLL", cdll)
    libs = [_build.load("libx") for _ in range(5)]
    assert all(lib is libs[0] for lib in libs)
    assert seen == {"hash": 1, "build": [["libx"]], "open": [str(path)]}


def _names_in(tree):
    """(line, what) of every stream fetch, require_sm90 call and "launch
    failed" string in ``tree``."""
    for node in ast.walk(tree):
        if isinstance(node, ast.Attribute) and node.attr in (
                "cuda_stream", "_cuda_getCurrentRawStream"):
            yield node.lineno, node.attr
        elif isinstance(node, ast.Call):
            f = node.func
            name = f.attr if isinstance(f, ast.Attribute) else getattr(
                f, "id", None)
            if name == "require_sm90":
                yield node.lineno, "require_sm90()"
        elif (isinstance(node, ast.Constant) and isinstance(node.value, str)
              and "launch failed" in node.value):
            yield node.lineno, "launch failed"


def test_only_the_seam_launches():
    """No module of the port but ``ops/_build.py`` fetches a stream,
    calls ``require_sm90`` or raises a launch failure."""
    files = glob.glob(os.path.join(REPO, "audioflux_torch", "**", "*.py"),
                      recursive=True)
    assert len(files) > 50
    seam = os.path.join(REPO, "audioflux_torch", "ops", "_build.py")
    bad, found = [], set()
    for path in files:
        with open(path) as f:
            tree = ast.parse(f.read(), filename=path)
        for line, what in _names_in(tree):
            if path == seam:
                found.add(what)
            else:
                bad.append(f"{os.path.relpath(path, REPO)}:{line} {what}")
    assert not bad, bad
    # the scan sees what the seam does
    assert found == {"_cuda_getCurrentRawStream", "require_sm90()",
                     "launch failed"}


@pytest.mark.parametrize("n", [8192, 16384])
def test_the_row_route_refuses_stage_2(n, card):
    """The row route (complex rows at 8192, 16384) cuts only at stage 1;
    stage 2 is refused before anything is launched."""
    x = torch.zeros((2, n))
    with pytest.raises(ValueError, match="no cut at stage 2"):
        cuda_fft._fwd(x, x, n, stages=2)
    assert card["checks"] == {}
