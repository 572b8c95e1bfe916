"""Cost model of one call, counted at dispatch: FLOPs, HBM bytes, peak
memory and kernel calls.  The twin of ``repro/launch/hlo_cost.py``.

``hlo_cost`` walks the HLO text of a compiled XLA program.  The port has
no HLO, so this module is a ``TorchDispatchMode`` over one call, on meta
tensors (the dry run: nothing is allocated anywhere) or on real ones, and
counts the aten ops that run.  It returns the keys of
``hlo_cost.analyze`` and two more:

  flops             2*prod(out)*prod(contracting) per product (``mm``,
                    ``bmm``, ``addmm``, ``baddbmm`` and what ``matmul``,
                    ``einsum`` and ``linear`` decompose into), and an
                    estimate for a convolution, as ``hlo_cost``'s
                    ``_dot_flops`` and ``_conv_flops``: the formulas of
                    ``torch.utils.flop_counter``, but for a convolution's
                    backward, where each gradient asked for costs the
                    forward's FLOPs with the groups honoured (that
                    formula counts a depthwise weight gradient as dense)
  hbm_bytes         Σ (operands + outputs) over the ops that materialise.
                    Views and bookkeeping ops (allocation, ``detach``)
                    are left out.  Unlike ``hlo_cost``'s ``_SKIP``,
                    elementwise ops count: the port runs eagerly and
                    nothing fuses them, so each reads its operands from
                    HBM and writes its output there.  An overwrite
                    (``copy_``, ``fill_``, ``zero_``) does not read its
                    destination; a scatter into a buffer moves its update
                    twice (read and written), as ``hlo_cost`` counts a
                    dynamic-update-slice
  collective_bytes  Σ operand bytes of the sharding rules' collectives
                    (``sharding/rules.py``), as ``hlo_cost`` sums them,
                    and one ``coll_<kind>`` key a kind (``all-reduce``,
                    ``all-gather``, ``reduce-scatter``): an all-reduce
                    is charged the tensor, an all-gather this rank's
                    block, a reduce-scatter the whole input, a gather
                    over two axes two all-gathers.  0 on one card.  A
                    collective's operand and result also count in
                    ``hbm_bytes``, as ``hlo_cost`` counts them; what its
                    backend runs inside it counts nothing more.  On an
                    abstract mesh (the dry run's) the collectives are
                    charged and not run
  peak_bytes        the highest sum of live storages over the call,
                    starting from the arguments' storages; an op's new
                    storage adds its bytes and leaves when its last
                    tensor is freed.  The outputs of views and in-place
                    ops share a storage and add nothing.  Not counted:
                    the caching allocator's rounding to 512 bytes and
                    cuBLAS's workspaces
  calls             calls of each hand-written kernel, by the names of
                    the launch counters

The charge at a kernel call (``mode="kernel"``, the default): each call
that ``kernels/ops.py`` or a kernel-backed backward makes through
``kernels/meter.py`` is charged the ``work(...)`` of the function it
computes (its kernel module's formula: FLOPs of the visible attention
pairs, the causal SSD pairs, ...; bytes of each input read once and each
output written once) and one call, and nothing of what runs inside it is
counted.  Its peak adds only what the call leaves alive: its outputs and
what its autograd Function saves.  The scratch the CUDA wrappers
allocate inside a call and free before it returns is left out.  So the
kernel path and the plain path of one step give the same count, and on
meta (where the plain path runs) the count is that of the card's kernel
path.  ``mode="plain"`` switches the charge off and counts the plain
path op by op, to be held against ``hlo_cost.analyze`` of the JAX
program: its FLOPs measure the plain path's arithmetic (the flash
reference computes masked blocks too), not the work.

    res = analyze(fn, *args, **kwargs)          # kernel mode
    res = analyze(fn, *args, mode="plain")
"""
from __future__ import annotations

import weakref
from collections import Counter
from typing import Any, Callable, Dict, Tuple

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import flop_registry

from repro_torch.kernels import meter

aten = torch.ops.aten

MODES = ("kernel", "plain")
# allocation and bookkeeping: no bytes move
_NO_BYTES = {aten.empty, aten.empty_strided, aten.empty_like, aten.new_empty,
             aten.new_empty_strided, aten.detach, aten.alias,
             aten.lift_fresh, aten._local_scalar_dense, aten.set_,
             aten.resize_}
# overwrites: the destination (the first argument) is written, not read
_WRITE_ONLY = {aten.copy_, aten.fill_, aten.zero_}
# in-place scatters into a buffer: the update moves, not the buffer
_SCATTER = {aten.index_put_, aten.index_copy_, aten.index_add_,
            aten.scatter_, aten.scatter_add_, aten.scatter_reduce_,
            aten.masked_scatter_}


def _conv_backward_flops(func, args, kwargs) -> float:
    a = dict(zip((x.name for x in func._schema.arguments), args), **kwargs)
    # the forward's FLOPs: 2 per output element and (C_in / groups) x
    # kernel weight; a transposed convolution's output is the input here
    out = a["input"] if a["transposed"] else a["grad_output"]
    fwd = 2.0 * out.numel() * a["weight"][0].numel()
    return fwd * sum(bool(m) for m in a["output_mask"][:2])


def _flops(func, args, kwargs, out) -> float:
    packet = func.overloadpacket
    if packet is aten.convolution_backward:
        return _conv_backward_flops(func, args, kwargs)
    return flop_registry[packet](*args, **kwargs, out_val=out)


def _tensors(tree, out=None) -> list:
    """The tensors in nested tuples, lists and dicts (faster than
    ``tree_flatten`` on an op's arguments, which this runs for each)."""
    out = [] if out is None else out
    if isinstance(tree, torch.Tensor):
        out.append(tree)
    elif isinstance(tree, (tuple, list)):
        for x in tree:
            _tensors(x, out)
    elif isinstance(tree, dict):
        for x in tree.values():
            _tensors(x, out)
    return out


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _storage(t: torch.Tensor):
    """(key, storage) of ``t``'s storage, or (None, None) for a tensor
    with none."""
    try:
        st = t.untyped_storage()
    except (RuntimeError, NotImplementedError, TypeError):
        return None, None
    return st._cdata, st


def _leave(c: "CostCounter") -> None:
    """The end of a charged call or a collective: once no such call is
    open, what it left alive (its outputs and saved tensors) is live."""
    c._inside -= 1
    if c._inside:
        return
    for key, n in list(c._pending.items()):
        c._pending.pop(key)
        c._live[key] = n
        c.live += n
    c.peak = max(c.peak, c.live)


class _Charge:
    """One kernel call under a counter (see ``kernels/meter.py``)."""

    def __init__(self, counter: "CostCounter", name: str,
                 work: Callable[[], Tuple[float, int]]):
        self.counter, self.name, self.work = counter, name, work
        self.charged = False

    def __enter__(self):
        c = self.counter
        if c._inside:  # a call inside a charged call is part of it
            return self
        c.calls[self.name] += 1
        if c.mode == "kernel":
            flops, n_bytes = self.work()
            c.flops += flops
            c.hbm_bytes += n_bytes
            c._inside += 1
            self.charged = True
        return self

    def __exit__(self, *exc) -> None:
        if self.charged:
            _leave(self.counter)


class _Collective:
    """One collective under a counter (see ``kernels/meter.py``): charged
    its bytes; the ops its backend dispatches inside it are not counted."""

    def __init__(self, counter: "CostCounter", kind: str, operand: int,
                 result: int):
        self.counter, self.kind = counter, kind
        self.operand, self.result = operand, result

    def __enter__(self):
        c = self.counter
        c.collectives[self.kind] += self.operand
        c.hbm_bytes += self.operand + self.result
        c._inside += 1
        return self

    def __exit__(self, *exc) -> None:
        _leave(self.counter)


class CostCounter(TorchDispatchMode):
    """Counts every aten op that runs while it is active; see the module
    docstring for what each total means."""

    def __init__(self, mode: str = "kernel"):
        super().__init__()
        if mode not in MODES:
            raise ValueError(f"mode must be one of {MODES}, got {mode!r}")
        self.mode = mode
        self.flops = 0.0
        self.hbm_bytes = 0
        self.calls: Counter = Counter()
        self.collectives: Counter = Counter()  # kind -> operand bytes
        self.live = self.peak = 0
        self._live: Dict[int, int] = {}  # storage key -> bytes, counted
        self._pending: Dict[int, int] = {}  # made inside a kernel call
        self._finalizers: Dict[int, Any] = {}
        self._inside = 0
        self._depth = 0

    # -- storages --------------------------------------------------------
    def _free(self, key: int) -> None:
        self._finalizers.pop(key, None)
        if key in self._live:
            self.live -= self._live.pop(key)
        self._pending.pop(key, None)

    def _adopt(self, key: int, st, pending: bool) -> None:
        n = st.nbytes()
        if pending:
            self._pending[key] = n
        else:
            self._live[key] = n
            self.live += n
            self.peak = max(self.peak, self.live)
        self._finalizers[key] = weakref.finalize(st, self._free, key)

    def _known(self, key: int) -> bool:
        return key in self._live or key in self._pending

    def track(self, tree) -> None:
        """Counts the storages of ``tree``'s tensors as live (the call's
        arguments), each storage once."""
        for t in _tensors(tree):
            key, st = _storage(t)
            if key is not None and not self._known(key):
                self._adopt(key, st, pending=False)

    # -- dispatch --------------------------------------------------------
    def charge(self, name: str, work) -> _Charge:
        return _Charge(self, name, work)

    def collective(self, kind: str, operand: int, result: int
                   ) -> _Collective:
        return _Collective(self, kind, operand, result)

    def __enter__(self):
        # entered again (without a new counter) to count a decomposition
        if not self._depth:
            meter.counters.append(self)
        self._depth += 1
        return super().__enter__()

    def __exit__(self, *exc):
        self._depth -= 1
        if not self._depth:
            meter.counters.remove(self)
            for f in list(self._finalizers.values()):
                f.detach()
            self._finalizers.clear()
        return super().__exit__(*exc)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        packet = func.overloadpacket
        if packet not in flop_registry and func.namespace == "aten" and \
                torch._C._dispatch_has_kernel_for_dispatch_key(
                    func.name(), "CompositeImplicitAutograd"):
            # a composite op that reached the mode whole (inference mode):
            # count what it decomposes into, as FlopCounterMode does
            with self:
                r = func.decompose(*args, **kwargs)
            if r is not NotImplemented:
                return r
        out = func(*args, **kwargs)
        ins = _tensors((args, kwargs))
        outs = _tensors(out)
        in_keys = {_storage(t)[0] for t in ins}
        fresh = False
        for t in outs:
            key, st = _storage(t)
            if key is None or key in in_keys or self._known(key):
                continue
            self._adopt(key, st, pending=bool(self._inside))
            fresh = True
        if self._inside:
            return out
        if packet in flop_registry:
            self.flops += _flops(func, args, kwargs, out)
        self.hbm_bytes += self._bytes(func, packet, args, ins, outs, fresh)
        return out

    @staticmethod
    def _bytes(func, packet, args, ins, outs, fresh: bool) -> int:
        if packet in _NO_BYTES or getattr(func, "is_view", False):
            return 0
        if not fresh and not func._schema.is_mutable:
            return 0  # a view by another name (_unsafe_view, ...)
        dest = args[0] if args and isinstance(args[0], torch.Tensor) \
            else None
        if packet in _SCATTER:
            return 2 * sum(_nbytes(t) for t in {id(t): t for t in ins
                                                 if t is not dest}.values())
        distinct = {id(t): t for t in ins}
        if packet in _WRITE_ONLY and dest is not None:
            distinct.pop(id(dest), None)
        return (sum(_nbytes(t) for t in distinct.values())
                + sum(_nbytes(t) for t in outs))

    def result(self) -> Dict[str, Any]:
        """The totals so far, as ``hlo_cost.analyze`` names them (with a
        ``coll_<kind>`` key a collective kind), plus ``peak_bytes`` and
        ``calls``."""
        return {"flops": float(self.flops),
                "hbm_bytes": float(self.hbm_bytes),
                "collective_bytes": float(sum(self.collectives.values())),
                **{f"coll_{k}": float(v) for k, v in
                   sorted(self.collectives.items())},
                "peak_bytes": self.peak, "calls": dict(self.calls)}


def _storage_bytes(tree) -> Dict[int, int]:
    out = {}
    for t in _tensors(tree):
        key, st = _storage(t)
        if key is not None:
            out[key] = st.nbytes()
    return out


def analyze(fn: Callable, *args, mode: str = "kernel",
            **kwargs) -> Dict[str, Any]:
    """Counts one call ``fn(*args, **kwargs)``.  Returns ``flops``,
    ``hbm_bytes``, ``collective_bytes`` (with its ``coll_<kind>`` keys),
    ``peak_bytes`` and ``calls``,
    and, each storage once, ``argument_bytes``, ``output_bytes`` and
    ``new_output_bytes`` (the outputs' storages that are no argument's)."""
    counter = CostCounter(mode)
    arg_st = _storage_bytes((args, kwargs))
    with counter:
        counter.track((args, kwargs))
        out = fn(*args, **kwargs)
        res = counter.result()
        out_st = _storage_bytes(out)
    res["argument_bytes"] = sum(arg_st.values())
    res["output_bytes"] = sum(out_st.values())
    res["new_output_bytes"] = sum(n for k, n in out_st.items()
                                  if k not in arg_st)
    return res
