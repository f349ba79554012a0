"""Compiled programs: the port's counterpart of ocrjax's `jax.jit`
executables and their caches.

ocrjax never runs its serving path op by op: each program is compiled once
per static shape, cached on the engine, and dispatched as one call that
returns before the device finishes. Here a `Program` wraps a function of
tensors; on the card it is captured once per key as CUDA graphs and
replayed from then on.

* Registry: every serving program an engine runs (the fused lane's, the
  staged detector's, the tile forward's, and those of `program`) is an
  entry of the engine's one registry (`engine_programs`, `held`). A
  config change, thresholds aside, empties it; an entry whose detector
  or tile mesh was replaced is made anew; either drops the graphs.

* Key: each tensor argument's shape, dtype and device, plus the non-tensor
  arguments (which must be hashable).
* First call with a key: the function runs eagerly on the device's
  capture stream (PyTorch wants a stream warmed up before a capture there)
  and that result is returned; then the function is captured again over
  static input buffers. A failed capture raises: nothing falls back to
  the eager route.
* Later calls copy the inputs into the static buffers on the current
  stream, replay, and return the static outputs, which the next replay of
  the same key overwrites: a caller that holds an output across another
  call of the program clones it. A tensor that several programs of one
  call read (the pages of a pooled recognition call) is written once into
  a `shared_buffer` of the device, which the programs then read without a
  copy each.
* One graph memory pool and one capture stream per device, shared by
  every engine's programs (the programs of one process run one after the
  other); replays run on the current stream.
* Stages: `utils.profiling.stage` marks split a capture, so a graph covers
  at most one innermost stage and the stages' CUDA events and profiler
  spans are recorded between replays, as on the eager route.
  `launched(fn, *args)` (the kernels' launch counters) runs fn at every
  replay of the graph that holds the launch, not at the capture.
* A program must not write its inputs; it may read no tensor other than
  its arguments and the engine's weights and constants. A `StepProgram`
  (a training step) is the one kind that writes state: its parameters,
  statistics and optimizer moments, which it names (see its docstring).
* On the CPU a program is its function. `eager()` runs every program op by
  op on the card (the counterpart of `jax.disable_jit()`); `EAGER` names
  the programs that always do, with the reason.
"""

from __future__ import annotations

import contextlib
import gc
import threading
import time
import warnings
from typing import Any, Callable, Dict, Iterator, Tuple

import torch
from torch.utils import _pytree as pytree

from ocrjax_torch.utils import profiling

# program name -> why it runs op by op on the card (none so far)
EAGER: Dict[str, str] = {}

_state = threading.local()      # .tape: the capture this thread is making
_eager_depth = [0]
_sync_checked = [0]


@contextlib.contextmanager
def eager() -> Iterator[None]:
    """Every program runs op by op inside the block (comparisons, counts
    of kernels)."""
    _eager_depth[0] += 1
    try:
        yield
    finally:
        _eager_depth[0] -= 1


@contextlib.contextmanager
def sync_checked() -> Iterator[None]:
    """Inside the block every program call (and every `checked()` span)
    runs under torch.cuda.set_sync_debug_mode("error"): a call that makes
    the host wait on the card raises."""
    _sync_checked[0] += 1
    try:
        yield
    finally:
        _sync_checked[0] -= 1


@contextlib.contextmanager
def checked() -> Iterator[None]:
    """A span that `sync_checked` holds to no host sync on the card."""
    if not _sync_checked[0] or not torch.cuda.is_available():
        yield
        return
    prev = torch.cuda.get_sync_debug_mode()
    torch.cuda.set_sync_debug_mode("error")
    try:
        yield
    finally:
        torch.cuda.set_sync_debug_mode(prev)


def launched(fn: Callable, *args) -> None:
    """fn(*args) now, or, while this thread captures a program, at every
    replay of the graph that holds the launch."""
    tape = getattr(_state, "tape", None)
    if tape is None:
        fn(*args)
    else:
        tape.items.append(("call", fn, args))


class CudaBackend:
    """What a capture needs of the card. The tests put a stand-in in its
    place to exercise the caches on the CPU."""

    def graph(self):
        return torch.cuda.CUDAGraph()

    def pool(self):
        return torch.cuda.graph_pool_handle()

    def stream(self, device: torch.device):
        return torch.cuda.Stream(device)

    def current(self, device: torch.device):
        return torch.cuda.current_stream(device)

    def on(self, stream):
        return torch.cuda.stream(stream)

    def wait(self, stream, other) -> None:
        stream.wait_stream(other)

    def keep(self, t: torch.Tensor, stream) -> None:
        t.record_stream(stream)

    def anchor(self, g: "DeviceGraphs"):
        """An empty graph captured into g's pool and kept with it: the
        allocator refuses a capture into a pool whose graphs are all gone,
        which a shared pool meets whenever every program holding a graph
        has been dropped."""
        anchor = self.graph()
        with self.on(g.stream), warnings.catch_warnings():
            warnings.filterwarnings("ignore", "The CUDA Graph is empty")
            anchor.capture_begin(pool=g.pool,
                                 capture_error_mode="thread_local")
            anchor.capture_end()
        return anchor

    def abandon(self, g: "DeviceGraphs") -> None:
        """After a capture that the card invalidated (an operation a
        capture forbids): the allocator stops routing the capture stream's
        allocations to the pool (PyTorch leaves that undone when its
        capture_end raises), and the captures after it take a new stream
        and a new pool."""
        end = getattr(torch._C, "_cuda_endAllocateToPool", None)
        if end is not None:
            index = g.device.index
            end(torch.cuda.current_device() if index is None else index,
                g.pool)
        g.stream = self.stream(g.device)
        g.pool = self.pool()
        g.anchor = self.anchor(g)

    def hold(self, tensors):
        """Around a StepProgram's capture: nothing to do, since a capture
        on the card records kernels without running them, so the state
        stays as the program's eager first call left it."""
        return contextlib.nullcontext()

    def release_cached(self, always: bool = False) -> None:
        """The cached blocks of every stream go back to the card, as
        torch.cuda.graph returns them before a capture, since a capture
        cannot free them when its pool needs memory: when under half the
        card is free, or `always`."""
        free, total = torch.cuda.mem_get_info()
        if always or free < total // 2:
            torch.cuda.synchronize()
            torch.cuda.empty_cache()


# device type -> backend; the CPU has none, so a program there is its
# function
BACKENDS: Dict[str, Any] = {"cuda": CudaBackend()}


class DeviceGraphs:
    """The graph memory pool and capture stream of one device, which
    every program on it shares (whatever engine holds the program). One
    pool lets each capture reuse the memory that earlier captures freed:
    with a pool per engine, chip_smoke.py's phase 10 (five float32
    engines alive at once) ran the H100 out of memory with 75.5 GiB in
    graph pools. The allocator lets no capture share a pool again once
    every graph in it is gone: an empty anchor graph, and the graphs of a
    failed capture, are kept with the pool. A capture that the card
    invalidates leaves PyTorch's CUDA random generators unusable in the
    process (no program here draws random numbers)."""

    def __init__(self, backend, device: torch.device):
        self.backend = backend
        self.device = torch.device(device)
        self.pool = backend.pool()
        self.stream = backend.stream(device)
        self.anchor = backend.anchor(self)
        # shared static inputs (shared_buffer): (name, shape, dtype) ->
        # buffer
        self.shared: Dict[Tuple, torch.Tensor] = {}
        self.failed = []


_device_graphs: Dict[Tuple, DeviceGraphs] = {}


def device_graphs(backend, device: torch.device) -> DeviceGraphs:
    key = (id(backend), torch.device(device))
    g = _device_graphs.get(key)
    if g is None or g.backend is not backend:
        g = _device_graphs[key] = DeviceGraphs(backend, device)
    return g


class _Tape:
    """One capture: CUDA graphs split at the stage marks, the marks, and
    the calls to make at each replay, in order."""

    def __init__(self, graphs: DeviceGraphs):
        self.g = graphs
        self.items = []
        self.cur = None
        self.thread = threading.get_ident()

    def begin(self) -> None:
        self.cur = self.g.backend.graph()
        self.cur.capture_begin(pool=self.g.pool,
                               capture_error_mode="thread_local")

    def end(self) -> None:
        g, self.cur = self.cur, None
        with warnings.catch_warnings():
            # a split between two stages may hold no kernel
            warnings.filterwarnings("ignore", "The CUDA Graph is empty")
            g.capture_end()
        self.items.append(("graph", g))

    def split(self, mark) -> None:
        self.end()
        self.items.append(mark)
        self.begin()

    @contextlib.contextmanager
    def stage(self, name: str) -> Iterator[None]:
        self.split(("enter", name))
        yield
        self.split(("exit", name))

    def record(self, fn: Callable, args, kw):
        # no collection during a capture: engines and their programs hold
        # each other, so the collector frees dropped programs' graphs, and
        # destroying a graph while a stream captures invalidates the capture
        collect = gc.isenabled()
        gc.disable()
        try:
            return self._record(fn, args, kw)
        finally:
            if collect:
                gc.enable()

    def _record(self, fn: Callable, args, kw):
        self.begin()
        _state.tape = self
        profiling.set_capture_hook(self)
        try:
            out = fn(*args, **kw)
            self.end()
        except BaseException:
            if self.cur is not None:
                try:
                    self.cur.capture_end()
                except RuntimeError:      # invalidated: raise the cause
                    self.g.backend.abandon(self.g)
                self.g.failed.append(self.cur)
                self.cur = None
            self.g.failed += [it[1] for it in self.items if it[0] == "graph"]
            raise
        finally:
            _state.tape = None
            profiling.set_capture_hook(None)
        return out

    def replay(self) -> None:
        opened = []
        for item in self.items:
            kind = item[0]
            if kind == "graph":
                item[1].replay()
            elif kind == "enter":
                cm = profiling.stage(item[1])
                cm.__enter__()
                opened.append(cm)
            elif kind == "exit":
                opened.pop().__exit__(None, None, None)
            else:
                item[1](*item[2])

    @property
    def n_graphs(self) -> int:
        return sum(1 for it in self.items if it[0] == "graph")


# a shared buffer holds at least a default chunk's pages, so that the
# calls of up to 16 pages capture their recognition programs once
MIN_SHARED_ROWS = 16


def _pow2(n: int) -> int:
    return 1 << max(0, n - 1).bit_length()


def shared_buffer(name: str, shape, dtype: torch.dtype,
                  device: torch.device) -> torch.Tensor:
    """A buffer of `shape` for several programs of one call to read
    without a copy each (the pages of a pooled recognition call): on the
    card the device's static buffer `name`, whose row count is shape[0]
    rounded up to a power of two and to at least MIN_SHARED_ROWS (the
    reference pads its page axis to a power of two, to bound its compiled
    programs; rows past shape[0] hold stale data and must not be read); a
    new tensor of `shape` where programs run op by op. The caller fills
    rows [:shape[0]]."""
    backend = None if _eager_depth[0] else BACKENDS.get(
        torch.device(device).type)
    if backend is None:
        return torch.empty(shape, dtype=dtype, device=device)
    g = device_graphs(backend, torch.device(device))
    k = (name, (_pow2(max(shape[0], MIN_SHARED_ROWS)),) + tuple(shape[1:]),
         dtype)
    buf = g.shared.get(k)
    if buf is None:
        buf = g.shared[k] = torch.zeros(k[1], dtype=dtype, device=device)
    return buf


class _Entry:
    def __init__(self, static_in, tape, static_out, capture_ms):
        self.static_in = static_in
        self.tape = tape
        self.static_out = static_out
        self.capture_ms = capture_ms
        self.replays = 0


class Program:
    """A function of tensors, captured as CUDA graphs once per key on the
    card (see the module's docstring); its graphs live until it is
    cleared or dropped (an engine's registry drops its programs by the
    rule of `held`)."""

    def __init__(self, fn: Callable, name: str):
        self.fn = fn
        self.name = name
        self.entries: Dict[Tuple, _Entry] = {}

    def clear(self) -> None:
        self.entries.clear()

    def programs(self):
        return (self,)

    @staticmethod
    def _key(args, kw) -> Tuple:
        return (tuple((tuple(a.shape), a.dtype, a.device)
                      if isinstance(a, torch.Tensor) else a for a in args),
                tuple(sorted(kw.items())))

    def __call__(self, *args, **kw):
        dev = next((a.device for a in args if isinstance(a, torch.Tensor)),
                   None)
        backend = None if dev is None else BACKENDS.get(dev.type)
        if (backend is None or _eager_depth[0] or self.name in EAGER
                or getattr(_state, "busy", False)):
            with checked():
                return self.fn(*args, **kw)
        with self._mode(), checked():
            self._check_state()
            key = self._key(args, kw)
            entry = self.entries.get(key)
            if entry is None:
                return self._capture(key, args, kw, backend, dev)
            for a, buf in zip(args, entry.static_in):
                if isinstance(a, torch.Tensor) and a is not buf:
                    buf.copy_(a)
            entry.tape.replay()
            entry.replays += 1
            return entry.static_out

    # hooks for StepProgram: the autograd mode of the calls on the card,
    # the check of the state before a call, what holds the state around
    # a capture
    def _mode(self):
        return torch.inference_mode()

    def _check_state(self) -> None:
        pass

    def _hold(self, backend):
        return contextlib.nullcontext()

    def _capture(self, key, args, kw, backend, dev):
        # a stage of its own, opened before the capture hook is set: a
        # capture inside a timed window is a stall that set-up left
        with profiling.stage("graph_capture", device=False):
            return self._capture_run(key, args, kw, backend, dev)

    def _capture_run(self, key, args, kw, backend, dev):
        t0 = time.perf_counter()
        g = device_graphs(backend, dev)
        shared = list(g.shared.values())
        static_in = [a.clone() if isinstance(a, torch.Tensor)
                     and not any(a is b for b in shared) else a
                     for a in args]
        cur = backend.current(dev)
        backend.wait(g.stream, cur)
        _state.busy = True
        try:
            with backend.on(g.stream):
                out = self.fn(*args, **kw)
                backend.release_cached()
                tape = _Tape(g)
                try:
                    with self._hold(backend):
                        static_out = tape.record(self.fn, static_in, kw)
                except torch.cuda.OutOfMemoryError:
                    # once more with every cached block returned; a second
                    # failure raises (the fused lane then halves its chunk)
                    backend.release_cached(always=True)
                    tape = _Tape(g)
                    with self._hold(backend):
                        static_out = tape.record(self.fn, static_in, kw)
        finally:
            _state.busy = False
        backend.wait(cur, g.stream)
        for t in pytree.tree_leaves(out) + list(args):
            if isinstance(t, torch.Tensor):
                backend.keep(t, cur)
        self.entries[key] = _Entry(static_in, tape, static_out,
                                   (time.perf_counter() - t0) * 1e3)
        return out

    def stats(self) -> Dict[Tuple, Dict[str, Any]]:
        """Per key: graphs a replay launches, capture ms (the first call
        whole: its eager run and the capture), replays since."""
        return {k: {"graphs": e.tape.n_graphs, "capture_ms": e.capture_ms,
                    "replays": e.replays} for k, e in self.entries.items()}


class StepProgram(Program):
    """A Program that updates state in place: a training step (forward,
    loss, backward, optimizer update), ocrjax's jitted train_step. It
    differs from a serving Program in four ways:

    * `state()` names every tensor the body writes or reads across calls
      besides its arguments: the model's parameters and buffers, the
      optimizer's moments and its per-step values (train.optim.step_state).
      Its storage is read and written in place at every replay.
    * The capture records each state tensor's identity and data_ptr and
      keeps a reference to it (its storage cannot be reused while the
      graphs live). Before a call the state is looked at again: when a
      tensor was replaced (a new tensor under a name, or a parameter's
      .data set to new storage), the program drops every graph it holds
      and captures anew from that call (`recaptures` counts it), since a
      replay would update storage the model no longer holds. Resuming a
      checkpoint and the mesh's unsharded() copy into the storage in
      place, so they recapture nothing.
    * It runs with autograd on, not in inference mode. The gradients the
      body allocates (the optimizer's zero_grad sets them to None, and
      the backward inside the capture makes them) come from the pool, and
      the parameters' .grad hold them after the capture: PyTorch's
      whole-network capture pattern.
    * The first call of a key runs eagerly on the capture stream and is
      the real step; the capture after it must leave the state as it is
      (on the card it runs nothing; `backend.hold` restores the state
      around a capture that runs the body, as the tests' stand-in does).

    Every per-step value (the learning rate, the bias corrections) must be
    in a state tensor that the caller refreshes before the call, outside
    the program (Adam.prepare), and the body must read nothing back to
    the host."""

    def __init__(self, fn: Callable, name: str,
                 state: Callable[[], Dict[str, torch.Tensor]]):
        super().__init__(fn, name)
        self.state = state
        self.recaptures = 0
        self._sig = None
        self._held = None

    def clear(self) -> None:
        super().clear()
        self._sig = self._held = None

    def _signature(self):
        st = self.state()
        return st, tuple((k, id(t), t.data_ptr(), tuple(t.shape), t.dtype)
                         for k, t in st.items())

    def _mode(self):
        return contextlib.nullcontext()

    def _check_state(self) -> None:
        st, sig = self._signature()
        if sig != self._sig:
            if self.entries:
                self.clear()
                self.recaptures += 1
            self._sig, self._held = sig, st

    def _hold(self, backend):
        return backend.hold(list(self._held.values()))


def owned_program(owner, name: str, fn: Callable) -> Program:
    """The Program `name` over fn kept on `owner` (a model: its
    evaluation forwards), made at first use; it reads the owner's
    parameters in place, so updates between two calls are seen. The
    first call's fn is kept: fn may close over the owner and nothing
    else."""
    progs = owner.__dict__.setdefault("_programs", {})
    p = progs.get(name)
    if p is None:
        p = progs[name] = Program(fn, name)
    return p


def program(engine, name: str, fn: Callable) -> Program:
    """The engine's Program `name` over fn, made at first use and kept in
    the engine's registry (held)."""
    return held(engine, name, lambda: Program(fn, name))


def held(engine, key, make: Callable, over=None):
    """The engine's entry `key` of its registry: a Program, or an object
    whose programs() are its Programs (a fused lane's FusedOcr, the tile
    forward), made by make() at first use. The one lifetime rule: an
    entry lives until the config changes (engine_programs) or until what
    it closes over besides the config and the fixed models, `over` (the
    detector it reads, the tile mesh), is no longer equal to what it was
    made over; then its graphs are dropped and make() makes it anew."""
    progs = engine_programs(engine)
    e = progs.get(key)
    if e is None or e[0] != over:
        if e is not None:
            _drop(e[1])
        e = progs[key] = (over, make())
    return e[1]


def engine_programs(engine) -> Dict[Any, Tuple[Any, Any]]:
    """engine._programs, the registry of every serving program the engine
    runs: key -> (what the entry was made over, the entry) (held). A
    change of the engine's config (thresholds aside, which programs take
    as tensors) empties it, since programs read the config in force when
    they were captured."""
    key = config_key(engine.config)
    if getattr(engine, "_programs_cfg", None) != key:
        for _, h in getattr(engine, "_programs", {}).values():
            _drop(h)
        engine._programs = {}
        engine._programs_cfg = key
    return engine._programs


def _drop(h) -> None:
    for p in h.programs():
        p.clear()


def config_key(cfg):
    """The config without the four detection thresholds: what a program
    closes over."""
    return cfg.replace(det_thresh=0.0, det_box_thresh=0.0,
                       det_unclip_ratio=0.0, det_min_box_size=0)


def all_programs(engine) -> Iterator[Program]:
    """Every program of the engine's registry."""
    for _, h in engine_programs(engine).values():
        yield from h.programs()
