"""The port's lookup of the native decoder library (clipbert_tpu_torch/
data/video.py::_load_native), on the CPU: a miss is not cached, so a
library that becomes loadable after a failed lookup (the native decoder
test's fixture builds it with ``make -C native``) is found on the next
call, and a hit is cached. And the eval datasets' count of videos that
fell back to black frames (clipbert_tpu_torch/data/datasets.py::
BaseDataset.eval_fallback_frames), which the eval runner's loader threads
move concurrently."""

import ctypes
import sys
import threading
import time
import types

from clipbert_tpu_torch.data import datasets, video


def _fake_ctypes(loadable):
    """ctypes with a CDLL that fails until ``loadable[0]`` is set, then
    returns a library with the two functions _load_native declares."""
    calls = []

    def cdll(path):
        calls.append(path)
        if not loadable[0]:
            raise OSError(f"{path}: cannot open shared object file")
        return types.SimpleNamespace(vdec_probe=types.SimpleNamespace(),
                                     vdec_decode_indices=types
                                     .SimpleNamespace())

    fake = types.SimpleNamespace(**{k: getattr(ctypes, k)
                                    for k in dir(ctypes)
                                    if not k.startswith("__")})
    fake.CDLL = cdll
    return fake, calls


def test_load_native_caches_only_a_hit(monkeypatch):
    loadable = [False]
    fake, calls = _fake_ctypes(loadable)
    monkeypatch.setattr(video, "ctypes", fake)
    monkeypatch.setattr(video, "_native_lib", None)
    assert video._load_native() is None
    assert not video.native_available()
    assert len(calls) == 2 * len(video._NATIVE_PATHS)   # looked up twice

    loadable[0] = True                  # the library is built meanwhile
    lib = video._load_native()
    assert lib is not None and video.native_available()
    assert lib.vdec_probe.restype is ctypes.c_int
    n = len(calls)
    assert video._load_native() is lib
    assert len(calls) == n              # a hit is not looked up again


class _YieldingInt(int):
    """An int whose addition gives up the interpreter between reading the
    count and storing the sum, so that an unlocked read-add-store from
    several threads loses updates at once instead of once in a while."""

    def __add__(self, other):
        time.sleep(0)
        return _YieldingInt(int(self) + other)


def test_fallback_count_is_exact_under_concurrent_calls(monkeypatch):
    """16 threads (more than the cores) x 200 fallbacks each on one
    dataset, as the eval runner's loader threads call it, with the
    interpreter switching threads every microsecond; the count must come
    out exact."""
    monkeypatch.setattr(datasets.LOGGER, "warning", lambda *a, **k: None)
    ds = datasets.BaseDataset([], None, None, device_preprocess=True)
    ds.n_fallbacks = _YieldingInt(0)
    n_threads, calls = 16, 200
    start = threading.Barrier(n_threads)
    shapes = set()

    def work():
        start.wait()
        for i in range(calls):
            shapes.add(ds.eval_fallback_frames(f"video{i}", 2).shape)

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=work) for _ in range(n_threads)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
    finally:
        sys.setswitchinterval(interval)
    assert not any(t.is_alive() for t in threads)
    assert ds.n_fallbacks == n_threads * calls
    assert shapes == {(2, 64, 64, 3)}
