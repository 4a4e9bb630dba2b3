"""One captured CUDA graph per input bucket: how the serving path launches a
whole encode or scoring call as one unit.

The JAX scorers run ONE compiled program per (clip config, caption bucket)
(clipbert_tpu/serve.py:9-15): a request launches it and never retraces.
The port's counterpart is a CUDA graph. At its first call for a bucket a
scorer runs the call once eagerly on a side stream (the kernels' builds,
cuBLAS and cuDNN handles and choices, the preprocess constants), then
captures it; every later call of that bucket copies its inputs into the
graph's static buffers, replays the graph and reads its static output. The
hand-written kernels are ctypes calls that ``torch.compile`` cannot see
into; a graph records them as they launch.

:class:`BucketGraphs` holds one scorer's graphs. They share one memory pool
and their static inputs (by argument position, shape and dtype: the cached
features of every text bucket are one buffer), so their replays must not
overlap: the lock (:meth:`BucketGraphs.locked`) serializes each
request's copy-ins, replays and copy-outs.
Built with ``enabled=False`` it runs every call eagerly and holds nothing.

The kernels' launch counters (``LAUNCHES`` etc. in ops/fused_attention.py,
ops/matmul_bn_act.py, ops/fused_stem_pool.py, and ``DENSE_*_CALLS`` in
ops/linear.py) count what runs on the card:
the eager warm-up counts, a capture adds nothing, and each replay adds the
launches its graph recorded. :data:`CAPTURES` counts the captures.
"""

from __future__ import annotations

import contextlib
import logging
import operator
import threading
from typing import Callable, Dict, Hashable, List, NamedTuple, Tuple

import numpy as np
import torch
from torch import nn

LOGGER = logging.getLogger(__name__)

# graphs captured in this process (or since a caller reset it)
CAPTURES = 0


def _counters() -> List[Tuple[object, str]]:
    from clipbert_tpu_torch.ops import (fused_attention, fused_stem_pool,
                                        linear, matmul_bn_act)
    return [(fused_attention, "LAUNCHES"), (fused_attention, "TC_LAUNCHES"),
            (fused_attention, "SHARD_HEADS_LAUNCHES"),
            (matmul_bn_act, "LAUNCHES"), (matmul_bn_act, "WG_LAUNCHES"),
            (fused_stem_pool, "LAUNCHES"), (fused_stem_pool, "TC_LAUNCHES"),
            (linear, "DENSE_KERNEL_CALLS"), (linear, "DENSE_WG_CALLS"),
            (linear, "DENSE_PLAIN_CALLS")]


def _read_counts() -> Tuple[int, ...]:
    return tuple(getattr(m, name) for m, name in _counters())


def _add_counts(delta) -> None:
    for (m, name), d in zip(_counters(), delta):
        setattr(m, name, getattr(m, name) + d)


class _ModelGuard:
    """The identity and storage of every parameter, buffer and submodule of
    a model when its graphs were captured. A graph reads parameters at the
    addresses it recorded, so a leaf replaced afterwards (a module swapped,
    as quantize_scoring_params does, or ``param.data`` reassigned) would be
    read stale; :meth:`check` raises instead. In-place updates keep the
    address and are read by the next replay."""

    def __init__(self, model: nn.Module):
        leaves = [(d, k, v) for m in model.modules()
                  for d in (m._parameters, m._buffers, m._modules)
                  for k, v in d.items()]
        self._dicts, self._keys, self._values = zip(*leaves)
        self._tensors = [v for v in self._values if torch.is_tensor(v)]
        self._ptrs = [t.data_ptr() for t in self._tensors]

    def check(self) -> None:
        """Raises if a leaf was replaced: 70-110 us a call at BERT-base +
        R50 on an H100 host (C-level loops over ~700 leaves), once a
        request."""
        same = all(map(operator.is_, map(dict.get, self._dicts, self._keys),
                       self._values))
        if not same or list(map(torch.Tensor.data_ptr,
                                self._tensors)) != self._ptrs:
            raise RuntimeError(
                "the scorer's model changed after its CUDA graphs were "
                "captured (a parameter, buffer or module was replaced); a "
                "scorer owns its model: build another scorer on another "
                "model instead")


class _Graph(NamedTuple):
    """One captured call: its graph, its static inputs and output, and the
    kernel launches it recorded."""
    graph: torch.cuda.CUDAGraph
    inputs: Tuple[torch.Tensor, ...]
    output: torch.Tensor
    launches: Tuple[int, ...]


class BucketGraphs:
    """One scorer's graphs, keyed by bucket (or, with ``enabled=False``,
    eager calls). ``model`` is the model the calls read: the graphs record
    its parameters' addresses."""

    def __init__(self, device: torch.device, model: nn.Module,
                 enabled: bool):
        self.device = torch.device(device)
        self.enabled = enabled
        self.lock = threading.Lock()
        self.warm = False     # set by the scorer's warmup: later captures log
        self._model = model
        self._graphs: Dict[Hashable, _Graph] = {}
        self._static: Dict[tuple, torch.Tensor] = {}
        self._staging: Dict[tuple, Tuple[torch.Tensor, torch.cuda.Event]] = {}
        self._guard = None
        # one pool and one capture stream: PyTorch keeps a cuBLAS workspace
        # per stream, which every graph captured on it shares
        self.pool = torch.cuda.graph_pool_handle() if enabled else None
        self._stream = torch.cuda.Stream(self.device) if enabled else None

    def __len__(self) -> int:
        return len(self._graphs)

    @contextlib.contextmanager
    def locked(self):
        """Holds the lock through one request's calls, from its first
        copy-in to its last copy-out, and checks once that the model is
        the one the graphs recorded."""
        with self.lock:
            if self._guard is not None:
                self._guard.check()
            yield

    def run(self, key: Hashable, fn: Callable, *args) -> torch.Tensor:
        """``fn(*args)`` on the device, as the replay of the graph of
        ``key`` (captured on its first call). numpy arrays are host inputs,
        staged through pinned memory; tensors lie on the device. Returns
        the graph's static output, which the next replay overwrites: call
        it inside :meth:`locked` and copy the output out before leaving."""
        with torch.inference_mode():
            if not self.enabled:
                return fn(*(torch.from_numpy(a).to(self.device)
                            if isinstance(a, np.ndarray) else a
                            for a in args))
            g = self._graphs.get(key)
            if g is None:
                g = self._capture(key, fn, args)
            else:
                self._copy_in(g.inputs, args)
            g.graph.replay()
            _add_counts(g.launches)
            return g.output

    def _static_inputs(self, args) -> Tuple[torch.Tensor, ...]:
        out = []
        for i, a in enumerate(args):
            dtype = (torch.from_numpy(a[:0]).dtype if isinstance(a, np.ndarray)
                     else a.dtype)
            k = (i, tuple(a.shape), dtype)
            if k not in self._static:
                self._static[k] = torch.empty(a.shape, dtype=dtype,
                                              device=self.device)
            out.append(self._static[k])
        return tuple(out)

    def _copy_in(self, inputs, args) -> None:
        for i, (dst, a) in enumerate(zip(inputs, args)):
            if tuple(a.shape) != tuple(dst.shape):
                raise ValueError(f"input {i} of shape {tuple(a.shape)} for "
                                 f"a graph captured at {tuple(dst.shape)}")
            if not isinstance(a, np.ndarray):
                dst.copy_(a)
                continue
            k = (i, tuple(a.shape), dst.dtype)
            if k not in self._staging:
                self._staging[k] = (torch.empty(a.shape, dtype=dst.dtype,
                                                pin_memory=True),
                                    torch.cuda.Event())
            host, copied = self._staging[k]
            copied.synchronize()    # the last copy out of it has finished
            host.numpy()[...] = a
            dst.copy_(host, non_blocking=True)
            copied.record()

    def _capture(self, key: Hashable, fn: Callable, args) -> _Graph:
        global CAPTURES
        if self._guard is None:
            self._guard = _ModelGuard(self._model)
        inputs = self._static_inputs(args)
        self._copy_in(inputs, args)
        side = self._stream
        side.wait_stream(torch.cuda.current_stream(self.device))
        with torch.cuda.stream(side):
            fn(*inputs)             # eager: builds, handles, choices
        torch.cuda.current_stream(self.device).wait_stream(side)
        before = _read_counts()
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph, pool=self.pool, stream=side):
            output = fn(*inputs)
        launches = tuple(a - b for a, b in zip(_read_counts(), before))
        _add_counts(tuple(-d for d in launches))    # a capture runs nothing
        CAPTURES += 1
        log = LOGGER.warning if self.warm else LOGGER.info
        log("captured the CUDA graph of bucket %s%s", key,
            " on its first request: it was not warmed" if self.warm else "")
        g = _Graph(graph, inputs, output, launches)
        self._graphs[key] = g
        return g
