"""The step replayed as CUDA graphs: make_step's graph path.

A step whose only host reads are the ends of its wave loops is captured
once, as one CUDA graph per phase span, and every later call replays the
graphs instead of issuing the step's kernels one by one. The graphs run the
same kernels on the same inputs as the eager step, so the results are the
same bytes.

- **Phases.** ``capture`` runs the step's body with ``phase=recorder.phase``
  in place of ``trace.span``: each phase (``step.auto_reset``,
  ``step.actions``, ...) begins a graph, and ``replay`` replays it inside
  the phase's ``trace.span``, so the profiler finds each phase's kernels in
  its own range. All graphs share one memory pool.
- **Wave loops.** A loop whose length depends on the data (the pure-move
  waves) calls ``capturing().wave_loop``: the graph before the loop ends by
  copying "more waves?" into a pinned host flag; one wave is captured as a
  graph of its own that updates the loop's carried tensors in place and
  copies the flag again; the phase's graph after the loop follows. Replay
  reads the flag after each graph through ``trace.host_read`` and replays
  the wave graph while it is set, so the loop runs exactly the eager
  number of waves, each read counted under the loop's site.
- **The state lives in the graphs' buffers.** The state given to the
  capturing call is adopted as the slots the first graph reads, and the
  last graph writes the new state back into them; the step returns the
  slots. A call given another state copies it into the slots first. The
  inputs (actions, agent order, reset maps) are copied into static
  buffers, and the carried observation buffer is adopted as the state is;
  a call given another buffer has it copied in and the new observations
  copied back into it. So the state and outputs a step returns are valid
  until its next call.
- **Launch counts.** A kernel wrapper launched under capture is noted with
  its graph (kernels.count_launch), and each replay of the graph adds its
  launches, so ``<wrapper>.launches`` counts what runs.

A host read inside a capture (``trace.host_read``) raises ``trace.CaptureBreak`` before it touches the device; ``capture``
then gives up and returns None, and the step stays eager. It does so too,
with a warning, where the capture refuses an operation.
"""

from __future__ import annotations

import contextlib
import warnings

import torch

from mettagrid_tpu_torch.engine import kernels
from mettagrid_tpu_torch.engine.state import EnvState, StepOutputs
from mettagrid_tpu_torch.profiling import trace

_recorder = None  # the open capture's _Recorder
MAX_LOOPS = 8  # wave loops a captured step may hold


def capturing():
    """The open capture's recorder, for the wave loops; None outside a capture."""
    return _recorder


class _Flag:
    """A device bool copied into pinned host memory at the end of a graph.
    As a truth value it waits for the event recorded after the graph and
    reads the copy."""

    def __init__(self):
        self.host = torch.zeros((1,), dtype=torch.bool, pin_memory=True)
        self.view = memoryview(self.host.numpy())
        self.event = torch.cuda.Event()

    def write(self, value: torch.Tensor) -> None:
        self.host.copy_(value.reshape(1), non_blocking=True)

    def __bool__(self) -> bool:
        self.event.synchronize()
        return self.view[0]


class _Graph:
    """A captured CUDA graph and the kernel wrappers it launches
    (kernels.count_launch): each replay adds their launches."""

    __slots__ = ("graph", "launched")

    def __init__(self, graph: torch.cuda.CUDAGraph, launched: list):
        self.graph, self.launched = graph, launched

    def replay(self) -> None:
        self.graph.replay()
        for wrapper in self.launched:
            wrapper.launches += 1


class _Loop:
    """A wave loop cut out of a phase: ``graph`` (one wave) replayed while
    ``flag``, which the graph before it and each wave write, reads true."""

    __slots__ = ("graph", "flag", "site", "counter", "base")

    def __init__(self, flag: _Flag, site: str, counter: str, base: int):
        self.graph = None
        self.flag = flag
        self.site, self.counter, self.base = site, counter, base

    def run(self) -> None:
        waves = self.base
        self.flag.event.record()
        while trace.host_read(self.flag, self.site):
            self.graph.replay()
            self.flag.event.record()
            waves += 1
        trace.count(self.counter, waves)


class _Recorder:
    """Cuts the step's body into graphs: one or more per phase span."""

    def __init__(self):
        self.pool = torch.cuda.graph_pool_handle()
        self.phases = []  # [(span name, [replay callables])]
        self.graph = None
        # Pinned memory cannot be allocated during a capture.
        self.flags = [_Flag() for _ in range(MAX_LOOPS)]

    def _begin(self) -> None:
        self.graph = torch.cuda.CUDAGraph()
        kernels.captured = []
        self.graph.capture_begin(pool=self.pool)

    def _end(self) -> _Graph:
        graph, self.graph = self.graph, None
        launched, kernels.captured = kernels.captured, None
        graph.capture_end()
        return _Graph(graph, launched)

    def cut(self) -> None:
        self.phases[-1][1].append(self._end().replay)

    def phase(self, name: str):
        """The body's phase context under capture: begins the graphs of the
        span ``name`` (the previous phase's last graph ends here)."""
        if self.graph is not None:
            self.cut()
        self.phases.append((name, []))
        self._begin()
        return contextlib.nullcontext()

    def wave_loop(self, wave, carry: tuple, more, site: str, counter: str, base: int) -> tuple:
        """The loop ``while more(carry): carry = wave(*carry)`` cut at its
        reads (see the module doc); ``base`` waves ran before it. Returns
        the carried tensors, which the wave graph rewrites in place."""
        if not self.flags:
            raise trace.CaptureBreak(f"more than {MAX_LOOPS} wave loops")
        carry = tuple(c.clone() for c in carry)
        loop = _Loop(self.flags.pop(), site, counter, base)
        loop.flag.write(more(carry))
        self.cut()
        self._begin()
        for c, new in zip(carry, wave(*carry)):
            c.copy_(new)
        loop.flag.write(more(carry))
        loop.graph = self._end()
        self.phases[-1][1].append(loop.run)
        self._begin()
        return carry

    def abandon(self) -> None:
        """Ends the open capture. A capture left open past the recorder
        aborts the process: the graph's destructor and the next tensor
        freed on the stream fail while it captures."""
        kernels.captured = None
        if self.graph is not None:
            with contextlib.suppress(Exception):
                self._end()


def _distinct(state: EnvState) -> EnvState:
    """The state with a copy of each field that shares memory with an
    earlier one, so that every slot can be written on its own."""
    seen, fields = set(), []
    for t in state:
        if t.numel():
            ptr = t.untyped_storage().data_ptr()
            if ptr in seen:
                t = t.clone()
            seen.add(t.untyped_storage().data_ptr())
        fields.append(t)
    return EnvState(*fields)


def _write_back(new: EnvState, slots: EnvState) -> None:
    """Copies each field of ``new`` that is not already its slot into the
    slot; a field read from another slot is copied aside first."""
    held = {t.untyped_storage().data_ptr() for t in slots if t.numel()}
    stores = []
    for name, dst, src in zip(EnvState._fields, slots, new):
        if src is dst or not dst.numel():
            continue
        if src.shape != dst.shape or src.dtype != dst.dtype:
            raise RuntimeError(f"step graphs: state field {name} changed from {tuple(dst.shape)} {dst.dtype} "
                               f"to {tuple(src.shape)} {src.dtype}")
        if src.untyped_storage().data_ptr() in held:
            src = src.clone()
        stores.append((dst, src))
    for dst, src in stores:
        dst.copy_(src)


class StepGraphs:
    """A captured step: ``takes`` says whether a call can replay it,
    ``replay`` runs one."""

    def __init__(self, phases, slots: EnvState, inputs: dict, obs_buf, out: StepOutputs, key: tuple):
        """obs_buf: the adopted observation buffer where the graphs rewrite
        it, else None."""
        self.phases = phases
        self.state = slots
        self.inputs = inputs
        self.obs_buf = obs_buf
        self.out = out
        self.key = key

    def takes(self, state: EnvState, inputs: dict, obs_buf, key: tuple) -> bool:
        """True when a call with these arguments replays the graphs: the
        same optional inputs given, and every tensor of the shape and dtype
        captured."""
        if key != self.key:
            return False
        if any(inputs[k].shape != v.shape for k, v in self.inputs.items()):
            return False
        if self.obs_buf is not None and (obs_buf.shape != self.obs_buf.shape or obs_buf.dtype != self.obs_buf.dtype):
            return False
        return state is self.state or all(
            s.shape == t.shape and s.dtype == t.dtype and s.device == t.device for s, t in zip(self.state, state)
        )

    def replay(self, state: EnvState, inputs: dict, obs_buf):
        """One step: copies the arguments into the slots where they are
        other tensors, replays each phase's graphs inside its span and
        returns the slots and the captured outputs. A call given an
        observation buffer other than the adopted one gets the observations
        written into its buffer too, as the eager step writes them."""
        if state is not self.state:
            for dst, src in zip(self.state, state):
                if src is not dst:
                    dst.copy_(src)
        for k, v in self.inputs.items():
            v.copy_(inputs[k])
        if self.obs_buf is not None and obs_buf is not self.obs_buf:
            self.obs_buf.copy_(obs_buf)
        for name, items in self.phases:
            with trace.span(name):
                for run in items:
                    run()
        if self.obs_buf is not None and obs_buf is not self.obs_buf:
            obs_buf.copy_(self.obs_buf)
            return self.state, self.out._replace(observations=obs_buf)
        return self.state, self.out


def capture(run, state: EnvState, inputs: dict, obs_buf, key: tuple):
    """Captures ``run(state, obs_buf=, phase=, **inputs)`` (make_step's
    body, on CUDA tensors) as graphs, adopting ``state`` and ``obs_buf`` as
    slots and copies of ``inputs`` (the tensors given, by keyword) as static
    inputs. Captures only: nothing runs. Returns the StepGraphs, or None
    where the body reads the host or the capture fails."""
    global _recorder
    slots = _distinct(state)
    static = {k: v.clone() for k, v in inputs.items()}
    # The eager steps' cached blocks go back to the device, so that the
    # graphs' pool does not hold its memory beside them (as torch.cuda.graph).
    torch.cuda.empty_cache()
    rec = _Recorder()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    _recorder = rec
    # A capture ends on the stream it began on, so the recorder gives up
    # inside the stream's context.
    with torch.cuda.stream(side):
        try:
            with trace.capturing():
                new, out = run(slots, obs_buf=obs_buf, phase=rec.phase, **static)
                _write_back(new, slots)
                rec.cut()
        except trace.CaptureBreak:
            rec.abandon()
            return None
        except Exception as exc:  # an operation a capture refuses, such as a copy from pageable host memory
            rec.abandon()
            warnings.warn(f"the step stays eager: capturing it as CUDA graphs failed ({exc})", RuntimeWarning)
            return None
        finally:
            _recorder = None
    torch.cuda.current_stream().wait_stream(side)
    by_id = {id(t): s for t, s in zip(new, slots)}
    out = StepOutputs(*(by_id.get(id(t), t) for t in out))
    # The routes that return a new observation tensor (obs.make_obs_fn) never
    # read the buffer, so a call's buffer is copied in only where it is read.
    read_buf = obs_buf if out.observations is obs_buf else None
    return StepGraphs(rec.phases, slots, static, read_buf, out, key)
