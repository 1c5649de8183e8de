"""CUDA-graph replay of a control tick: the port's counterpart of ``jax.jit``.

The JAX package compiles its control tick once and donates the carry
(``jax.jit(..., donate_argnums=0)``, ``opendog_tpu/solvers/mpc.py:236-260``),
so a tick costs one dispatch.  Run eagerly, the same tick issues a few
thousand small PyTorch launches from the host, and the host's issue, not the
card, sets its time.  :class:`GraphedTick` records one call of a tick into a
``torch.cuda.CUDAGraph`` over static input buffers and replays it: the host
then issues a few input copies and one graph launch per tick.
"""
from __future__ import annotations

import collections
import gc
from typing import Callable, Sequence

import torch

from ..ops import cuda_step


class GraphedTick:
    """``fn(*inputs)`` captured once in a CUDA graph and replayed.

    ``example_inputs`` (tensors) give the inputs' shapes and dtypes: they
    are copied into static input buffers on ``device`` (``inputs``).  ``fn``
    then runs once eagerly on a side stream, so that every kernel it holds
    is loaded (and the substep kernels' shared-memory opt-in made) before
    the capture, and one call of it is captured.  ``fn`` must be a function
    of its input tensors alone: it reads nothing from the host, draws no
    random numbers (pass the normals in) and writes none of its inputs.

    ``__call__(*inputs)`` copies each input into its static buffer (a
    buffer passed as itself is not copied; a pinned host tensor is copied
    without blocking), replays the graph on the current stream and returns
    ``fn``'s outputs as captured.  They are static tensors that the next
    call overwrites: clone what you keep.

    Only on CUDA: another device raises, and nothing falls back to an eager
    call.  A capture error propagates as it is.

    ``cuda_step.LAUNCHES`` counts kernel launches in Python, so the capture
    would count launches that never ran and a replay none.  The capture's
    counts are taken out of the counter (kept in ``launches``) and added
    back once per replay.

    Python's cyclic garbage collector is held off during the capture: a
    collection there may free an unreachable object that owns another CUDA
    graph, and destroying a graph while a stream captures invalidates the
    capture (PyTorch no longer collects before a capture).

    The graph keeps ``fn`` (``self.fn``), and through it every tensor that
    ``fn`` reads without taking it as an input (a kernel's model table, a
    cost's constants): the graph holds their device addresses, and were
    they freed, the allocator would hand their memory to other tensors
    while replays still read it.
    """

    def __init__(self, fn: Callable, example_inputs: Sequence[torch.Tensor],
                 device):
        device = torch.device(device)
        if device.type != "cuda":
            raise ValueError(f"a CUDA graph needs a CUDA device, got {device}")
        self.fn = fn
        self.inputs = tuple(torch.empty_like(x, device=device).copy_(x)
                            for x in example_inputs)
        with torch.cuda.device(device):
            current = torch.cuda.current_stream()
            side = torch.cuda.Stream()
            side.wait_stream(current)
            with torch.cuda.stream(side):
                fn(*self.inputs)
            current.wait_stream(side)
            # keep_graph: the captured graph stays readable (its node
            # count, raw_cuda_graph) after instantiation
            self.graph = torch.cuda.CUDAGraph(keep_graph=True)
            before = collections.Counter(cuda_step.LAUNCHES)
            collecting = gc.isenabled()
            gc.disable()
            try:
                with torch.cuda.graph(self.graph):
                    self.outputs = fn(*self.inputs)
            finally:
                if collecting:
                    gc.enable()
                self.launches = cuda_step.LAUNCHES - before
                cuda_step.LAUNCHES.clear()
                cuda_step.LAUNCHES.update(before)

    def __call__(self, *inputs):
        if len(inputs) != len(self.inputs):
            raise ValueError(f"expected {len(self.inputs)} inputs, got "
                             f"{len(inputs)}")
        for i, (buf, x) in enumerate(zip(self.inputs, inputs)):
            if x is buf:
                continue
            if x.shape != buf.shape:
                raise ValueError(f"input {i} has shape {tuple(x.shape)}, the "
                                 f"graph's {tuple(buf.shape)}")
            buf.copy_(x, non_blocking=True)
        self.graph.replay()
        cuda_step.LAUNCHES.update(self.launches)
        return self.outputs
