"""The program of a compiled step: the port's counterpart of the jaxpr
that ``jax.make_jaxpr`` gives the reference's ``to_static``
(``paddle_tpu/jit/api.py`` ``_finalize_entry``).

The first call of a new signature runs the function eagerly under a
``TorchDispatchMode`` (:class:`Recorder`) that writes down every aten op
it dispatches: the op's name, its operands' and results' storages,
shapes and dtypes, which operands it writes in place, and its Python
number arguments. That first call is a real step, as the reference's
first call traces, compiles and executes.

A hand-written kernel is one op of the program on either device
(``ops/kernels.program_op``): named after the kernel, reading the
wrapper's tensor arguments and writing its results. The plain version's
ops on the CPU and the allocations of the CUDA route are not recorded,
as the reference's jaxpr holds one ``pallas_call``, so a program has the
same ops on the CPU and on the card.

Storages are named by a number of their own (``uid``), not by address:
the caching allocator hands a freed address out again, and a view or an
in-place result names the storage of the operand its schema aliases.

A read of a tensor on the host (``aten._local_scalar_dense``: what
``.item()``, ``bool()``, ``int()`` and ``float()`` call, and
``.tolist()`` and ``.numpy()``, which read a CPU tensor's memory without
dispatching an op) raises :class:`HostReadError` inside a recorded or
captured run, on either device: a captured graph would replay the value
read at capture.
"""
from __future__ import annotations

import collections
import contextlib
import dataclasses
from typing import Dict, List, Optional, Tuple

import torch
from torch.overrides import TorchFunctionMode
from torch.utils import _pytree as pytree
from torch.utils._python_dispatch import TorchDispatchMode


def capturing() -> bool:
    """Whether ``jit.to_static`` is capturing a CUDA graph."""
    from ..ops import kernels

    return kernels._CAPTURING > 0


@contextlib.contextmanager
def capture_scope():
    """The body is a capture: the kernel wrappers count no launch (the
    capture launches nothing; its replays do)."""
    from ..ops import kernels

    kernels._CAPTURING += 1
    try:
        yield
    finally:
        kernels._CAPTURING -= 1


class HostReadError(RuntimeError):
    """A tensor was read on the host inside a compiled step."""


_HOST_READ = torch.ops.aten._local_scalar_dense.default


def _host_read_error(func, args) -> HostReadError:
    t = next((a for a in args if isinstance(a, torch.Tensor)), None)
    what = "" if t is None else (
        f" of a {tuple(t.shape)} {str(t.dtype).replace('torch.', '')} "
        f"tensor on {t.device}")
    return HostReadError(
        f"jit.to_static: a compiled step read a tensor on the host "
        f"({func}{what}: .item(), bool(), int(), float() or .tolist()). "
        "A captured CUDA graph would replay the value read at capture, so "
        "the port refuses it. Keep the value on the device (torch.where, "
        "index ops) or take it out of the compiled function: dy2static's "
        "control-flow conversion (paddle_tpu/jit/dy2static.py) is not "
        "ported yet.")


def dtype_name(dtype) -> str:
    return str(dtype).replace("torch.", "")


@dataclasses.dataclass(frozen=True)
class TensorRef:
    """One tensor operand or result of an op: its storage's ``uid``, its
    shape and dtype, and the bytes of the tensor itself."""
    uid: int
    shape: Tuple[int, ...]
    dtype: str
    nbytes: int


@dataclasses.dataclass
class OpRecord:
    """One op of a program. ``writes``: the uids of the operands it
    writes in place. ``scalars``: its Python number arguments.
    ``kernel``: a hand kernel's op, with the CUDA ``launches`` it made
    (``{kernel: n}``, empty on the CPU)."""
    name: str
    operands: List[TensorRef]
    results: List[TensorRef]
    writes: List[int]
    scalars: Tuple = ()
    kernel: bool = False
    launches: Dict[str, int] = dataclasses.field(default_factory=dict)

    @property
    def packet(self) -> str:
        """The op without its overload: ``mm`` of ``aten.mm.default``."""
        parts = self.name.split(".")
        return parts[1] if len(parts) > 2 else parts[-1]


@dataclasses.dataclass
class Program:
    """A recorded step. ``storage_bytes``: every storage's size by uid.
    ``input_uids`` / ``state_uids``: the storages of the arguments' and
    the state's tensors when the call began. ``output_uids``: the
    storages of the returned tensors; ``left_uids``: those the step left
    on the state (gradients)."""
    ops: List[OpRecord]
    storage_bytes: Dict[int, int]
    input_uids: List[int]
    state_uids: List[int]
    output_uids: List[int]
    left_uids: List[int]
    device: str

    def __len__(self):
        return len(self.ops)

    def const_refs(self) -> List[TensorRef]:
        """Tensors an op reads that are neither arguments, state nor
        produced in the program: what the function closed over."""
        known = set(self.input_uids) | set(self.state_uids)
        out, seen = [], set()
        for op in self.ops:
            for t in op.operands:
                if t.uid not in known and t.uid not in seen:
                    seen.add(t.uid)
                    out.append(t)
            known.update(r.uid for r in op.results)
        return out

    def launches(self) -> Dict[str, int]:
        out = collections.Counter()
        for op in self.ops:
            out.update(op.launches)
        return dict(out)


class _StorageIds:
    """A uid per live storage. A storage that was freed and whose address
    came back is a new storage (its weak reference has expired)."""

    def __init__(self):
        from torch.multiprocessing.reductions import StorageWeakRef

        self._weak = StorageWeakRef
        self._by_key: Dict[int, tuple] = {}
        self.nbytes: Dict[int, int] = {}
        self._n = 0

    def lookup(self, t) -> Optional[int]:
        st = t.untyped_storage()
        hit = self._by_key.get(st._cdata)
        if hit is not None and not hit[1].expired():
            return hit[0]
        return None

    def bind(self, t, uid):
        st = t.untyped_storage()
        self._by_key[st._cdata] = (uid, self._weak(st))
        self.nbytes.setdefault(uid, int(st.nbytes()))

    def uid(self, t) -> int:
        uid = self.lookup(t)
        if uid is None:
            self._n += 1
            uid = self._n
            self.bind(t, uid)
        return uid


def _tensors(tree):
    return [t for t in pytree.tree_leaves(tree)
            if isinstance(t, torch.Tensor)]


def _scalars(tree):
    return tuple(x for x in pytree.tree_leaves(tree)
                 if isinstance(x, (int, float)) and not isinstance(x, bool))


class CaptureGuard(TorchDispatchMode):
    """The dispatch mode of a capture: refuses host reads, and collects
    the storages the captured ops read that the capture did not allocate
    (the arguments', the state's, and what the function closed over,
    such as a model's cached RoPE tables). The graph reads them by
    address at every replay, so its entry keeps them alive
    (``external``)."""

    def __init__(self):
        super().__init__()
        self._made = set()
        self.external = {}

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if func is _HOST_READ:
            raise _host_read_error(func, args)
        kwargs = kwargs or {}
        for t in _tensors((args, kwargs)):
            st = t.untyped_storage()
            if st._cdata not in self._made:
                self.external.setdefault(st._cdata, st)
        out = func(*args, **kwargs)
        for t in _tensors(out):
            st = t.untyped_storage()
            if st._cdata not in self.external:
                self._made.add(st._cdata)
        return out


class _ReadingMethods(TorchFunctionMode):
    """Refuses ``Tensor.tolist`` and ``Tensor.numpy``, which read a CPU
    tensor without dispatching an op."""

    _NAMES = ("tolist", "numpy")

    def __torch_function__(self, func, types, args=(), kwargs=None):
        if getattr(func, "__name__", None) in self._NAMES:
            raise _host_read_error(func, args)
        return func(*args, **(kwargs or {}))


@contextlib.contextmanager
def capture_guard():
    """The body is a capture: every host read of a tensor raises, and
    the yielded :class:`CaptureGuard` collects the storages the graph
    reads from outside it."""
    guard = CaptureGuard()
    with _ReadingMethods(), guard:
        yield guard


class Recorder(TorchDispatchMode):
    """Writes down the aten ops of one eager run (see the module
    docstring). Kernel wrappers report themselves through
    :meth:`kernel_op` and :meth:`launch`."""

    def __init__(self):
        super().__init__()
        self.ops: List[OpRecord] = []
        self.ids = _StorageIds()
        self._suspended = 0
        self._launches: Optional[collections.Counter] = None

    def ref(self, t) -> TensorRef:
        return TensorRef(self.ids.uid(t), tuple(t.shape),
                         dtype_name(t.dtype), t.numel() * t.element_size())

    def register(self, tensors) -> List[int]:
        return [self.ids.uid(t) for t in tensors]

    # -- the dispatch hook -------------------------------------------------
    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if func is _HOST_READ:
            raise _host_read_error(func, args)
        out = func(*args, **kwargs)
        if not self._suspended and func.namespace == "aten":
            self._record(func, args, kwargs, out)
        return out

    def _record(self, func, args, kwargs, out):
        schema = func._schema
        operands = [self.ref(t) for t in _tensors((args, kwargs))]
        by_set, writes = {}, []
        for i, a in enumerate(schema.arguments):
            if a.alias_info is None:
                continue
            v = args[i] if i < len(args) else kwargs.get(a.name)
            for name in a.alias_info.before_set:
                by_set[name] = v
            if a.alias_info.is_write:
                writes += [self.ids.uid(t) for t in _tensors(v)]
        outs = out if isinstance(out, (tuple, list)) else (out,)
        results = []
        for i, o in enumerate(outs):
            ret = schema.returns[i] if i < len(schema.returns) else None
            aliased = None
            if ret is not None and ret.alias_info is not None:
                for name in ret.alias_info.before_set:
                    if name in by_set:
                        aliased = _tensors(by_set[name])
            for j, t in enumerate(_tensors(o)):
                if aliased and self.ids.lookup(t) is None:
                    # a view or an in-place result names its operand's
                    # storage (under a fake mode its storage differs)
                    src = aliased[min(j, len(aliased) - 1)]
                    self.ids.bind(t, self.ids.uid(src))
                results.append(self.ref(t))
        self.ops.append(OpRecord(str(func), operands, results, writes,
                                 _scalars((args, kwargs))))

    # -- kernel wrappers (ops/kernels/__init__.py) -------------------------
    def kernel_op(self, kernel, run, args, kwargs):
        """Runs ``run(*args, **kwargs)`` (a kernel wrapper's dispatch) as
        one op named ``kernel``."""
        operands = [self.ref(t) for t in _tensors((args, kwargs))]
        outer = self._launches
        self._launches = collections.Counter()
        self._suspended += 1
        try:
            out = run(*args, **kwargs)
        finally:
            self._suspended -= 1
            launches, self._launches = self._launches, outer
        results = [self.ref(t) for t in _tensors(out)]
        self.ops.append(OpRecord(kernel, operands, results, [],
                                 _scalars((args, kwargs)), kernel=True,
                                 launches=dict(launches)))
        return out

    def launch(self, kernel, operands, results):
        """A CUDA launch (``record_launch``): counted on the kernel op
        that made it, or, from a wrapper without ``program_op``, an op
        of its own over the launch's operands and results."""
        if self._launches is not None:
            self._launches[kernel] += 1
            return
        self.ops.append(OpRecord(
            kernel, [self.ref(t) for t in operands if t is not None],
            [self.ref(t) for t in results], [], kernel=True,
            launches={kernel: 1}))

    def program(self, input_uids, state_uids, outputs, left, device):
        return Program(
            ops=self.ops, storage_bytes=dict(self.ids.nbytes),
            input_uids=list(input_uids), state_uids=list(state_uids),
            output_uids=[self.ids.uid(t) for t in _tensors(outputs)],
            left_uids=[self.ids.uid(t) for t in left], device=device)


@contextlib.contextmanager
def recording():
    """A :class:`Recorder` active for the body, and the kernel wrappers
    reporting to it."""
    from ..ops import kernels

    rec = Recorder()
    outer = kernels._RECORDER
    kernels._RECORDER = rec
    try:
        with _ReadingMethods(), rec:
            yield rec
    finally:
        kernels._RECORDER = outer
