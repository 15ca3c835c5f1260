"""The attack step's model forward and input gradient as one CUDA graph.

An inner step of the attack step launches thousands of small kernels (the
towers' blocks three times, the decoder's twice, with per-block
recomputation), and on the card the host's launches, not the kernels, set
its pace. The work from the pixels on is the same at every inner step of
every outer step of one batch shape: the frozen VLA's forward, the
objective and `torch.autograd.grad` with respect to the bf16 pixels, the
checkpointed blocks' recomputation inside it. So it is captured once into a
`torch.cuda.CUDAGraph` and replayed:

  - eager, before the replay: the patch paste, the warp, the composite, the
    normalization and the cast (they slice by the draws' Python ints), whose
    result is copied into the graph's static `pixels` leaf;
  - the graph: `engine.pixel_loss_and_grad` on static buffers (the pixels,
    and the batch's ids, mask and prepared labels, copied in once an outer
    step);
  - eager, after it: the paste chain's backward from the pixel gradient to
    the patch, and the optimizer's update.

The eager step runs the same split (`engine.patch_loss_and_grad`), with
`pixel_loss_and_grad` run in place of the replay. A step function keeps one
graph (`GraphedObjective`), keyed by the shapes, dtypes and device of the
batch and the parameters' storage: the first call with a new key runs eager
(the warm-up a capture needs: the kernels' lazy build, cuBLAS handles, the
autograd engine's threads), the second captures and replays. The step uses
it only on a CUDA device without a mesh (`applies`).

What the region counts and keeps for the recorder (`utils/profiling.count`
and `keep`) is tallied at the capture and credited at every replay. The
kernels' own launch counters count where their wrappers launch: once, into
the graph, at the capture; a replay adds nothing to them.
"""

from __future__ import annotations

from typing import Callable, Dict, Iterator, Mapping, Optional, Tuple

import torch

from ..utils.profiling import count, credit, span, tallying


def applies(device, mesh) -> bool:
    """Whether the attack step replays a graph: on a CUDA device, without a
    mesh (the data- and model-axis collectives stay eager)."""
    return mesh is None and torch.device(device).type == "cuda"


class CudaGraph(torch.cuda.CUDAGraph):
    """A `torch.cuda.CUDAGraph` whose capture refuses a synchronizing call."""

    def capture(self, fn: Callable):
        """fn's outputs, captured, not run (they hold the first replay's
        results once it has run). A synchronizing call inside raises."""
        with torch.cuda.graph(self):
            mode = torch.cuda.get_sync_debug_mode()
            torch.cuda.set_sync_debug_mode("error")
            try:
                return fn()
            finally:
                torch.cuda.set_sync_debug_mode(mode)


def _tensors(tree) -> Iterator[torch.Tensor]:
    if isinstance(tree, torch.Tensor):
        yield tree
    elif isinstance(tree, Mapping):
        for v in tree.values():
            yield from _tensors(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _tensors(v)


def _key(params, tensors) -> tuple:
    """What a graph is specific to: the parameters' storage, shapes and
    dtypes, and the shapes, dtypes and device of the step's inputs."""
    return (tuple((t.data_ptr(), t.shape, t.dtype) for t in _tensors(params)),
            tuple((t.shape, t.dtype, t.device) for t in tensors))


class GraphedObjective:
    """A step function's graph of `region(params, ids, mask, labels,
    pixels) -> (loss, metrics, pixel_grad)`: `prepare` once an outer step,
    then `run` at each inner step. Holds the graph of one key, its static
    inputs (the batch's, and `pixels` from the capture on), its outputs and
    what its capture tallied."""

    def __init__(self, region: Callable) -> None:
        self.region = region
        self.key: Optional[tuple] = None
        self.graph = self.params = self.inputs = self.pixels = self.outputs = self.tally = None

    def prepare(self, params, images, ids, mask, labels) -> Optional[Callable]:
        """`run` for this outer step's inner steps, with `ids`, `mask` and
        `labels` in the graph's buffers; or None, and the call runs eager:
        the first call with a new key (the old graph is dropped)."""
        key = _key(params, (images, ids, mask, labels))
        if key != self.key:
            self.key = key
            self.graph = self.params = self.inputs = self.pixels = self.outputs = self.tally = None
            return None
        if self.graph is None:
            self.graph, self.params, self.inputs = CudaGraph(), params, [t.clone() for t in (ids, mask, labels)]
        with torch.no_grad():
            for buf, t in zip(self.inputs, (ids, mask, labels)):
                buf.copy_(t)
        return self.run

    def run(self, pixels: torch.Tensor) -> Tuple[torch.Tensor, Dict[str, torch.Tensor], torch.Tensor]:
        """One replay on `pixels` (captured at the first): (loss, metrics,
        pixel gradient). The loss and metrics are copies; the gradient is
        the graph's own output, which the next replay overwrites."""
        with span("attack.graph"):
            if self.outputs is None:
                self.pixels = pixels.detach().clone().requires_grad_(True)
                with tallying() as self.tally:
                    self.outputs = self.graph.capture(
                        lambda: self.region(self.params, *self.inputs, self.pixels))
            with torch.no_grad():
                self.pixels.copy_(pixels)
            self.graph.replay()
            credit(self.tally)
            count("attack.graph_replays")
            loss, metrics, grad = self.outputs
            return loss.clone(), {k: v.clone() for k, v in metrics.items()}, grad
