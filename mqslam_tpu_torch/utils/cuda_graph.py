"""A pure tensor function replayed as one CUDA graph per input signature on
a card, and called as it is on any other device.

``Graphed(fn, device, name)`` wraps ``fn(*tensors)``, which returns a tensor
or a tuple (NamedTuple) of tensors, reads nothing but its arguments, writes
none of them, draws no random numbers and reads nothing back to the host.

On a CUDA ``device`` the first call with a new signature (each argument's
shape and dtype) copies the arguments into static buffers on ``device``,
runs ``fn`` once on a side stream (it builds what ``fn`` caches and fills
the allocator), captures it under ``torch.no_grad()`` and replays it; every
later call with that signature copies its arguments in and replays.  A
replay launches the very kernels of an eager call, in the same order, so its
outputs are bit-equal to ``fn``'s on the same inputs.  Each call, copy-in
and replay (and the capture, on the first), is the span ``name``
(``utils.profiling``) while tracing is on.

The outputs are then the graph's static buffers: the next call's replay
overwrites them, and its copy-in the static inputs (which ``fn`` may pass
through as outputs).  A caller consumes them before calling again and
copies whatever must outlive the call.

On any other device a call is ``fn(*args)``: no copy, no capture and no
span.  A caller written for the card runs unchanged there.
"""

import torch

from mqslam_tpu_torch.utils import profiling

__all__ = ["Graphed"]


class Graphed:
    """``fn`` captured once per signature of its arguments, then replayed,
    on a card; ``fn`` itself elsewhere (see the module docstring).
    ``graphs`` maps each signature to its (graph, static inputs, static
    outputs)."""

    def __init__(self, fn, device, name):
        self.fn, self.device, self.name = fn, torch.device(device), name
        self.graphs = {}

    def __call__(self, *args):
        if self.device.type != "cuda":
            return self.fn(*args)
        with profiling.span(self.name, self.device):
            key = tuple((tuple(a.shape), a.dtype) for a in args)
            entry = self.graphs.get(key)
            if entry is None:
                entry = self.graphs[key] = self._capture(args)
            else:
                for s, a in zip(entry[1], args):
                    s.copy_(a)
            graph, _, out = entry
            graph.replay()
        return out

    def _capture(self, args):
        with torch.cuda.device(self.device), torch.no_grad():
            static = tuple(torch.empty(a.shape, dtype=a.dtype,
                                       device=self.device) for a in args)
            for s, a in zip(static, args):
                s.copy_(a)
            stream = torch.cuda.current_stream()
            side = torch.cuda.Stream()
            side.wait_stream(stream)
            with torch.cuda.stream(side):
                self.fn(*static)
            stream.wait_stream(side)
            graph = torch.cuda.CUDAGraph()
            with torch.cuda.graph(graph):
                out = self.fn(*static)
        return graph, static, out
