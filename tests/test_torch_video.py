"""The port's lookup of the native decoder library (clipbert_tpu_torch/
data/video.py::_load_native), on the CPU: a miss is not cached, so a
library that becomes loadable after a failed lookup (the native decoder
test's fixture builds it with ``make -C native``) is found on the next
call, and a hit is cached."""

import ctypes
import types

from clipbert_tpu_torch.data import video


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
