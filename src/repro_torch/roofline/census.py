"""Census of one run: FLOPs, bytes, collective bytes and the peak of live
bytes (port of ``repro/roofline/census.py``).

The reference parses the compiled HLO (trip counts times loop bodies).
Eager torch has no program to parse, so :class:`Census` watches the run
itself, op by op:

  * **FLOPs**: ``torch.utils.flop_counter``'s formulas (the registry that
    ``FlopCounterMode`` reads) over every aten op the run dispatches, the
    backward's and the remat recompute's included (a loop of n trips
    dispatches its body n times, so no trip count is needed).  They are
    applied inside the census's one dispatch mode: a second mode, a
    ``FlopCounterMode`` beside it, doubled the dry run's time, and counts
    the same (``tests/test_torch_roofline.py``);
  * **bytes**: every aten op's input and output bytes (a tensor's elements
    times their size), views, allocations without a write and the
    collectives' own ops left out.  This is eager torch's analogue of
    XLA's "bytes accessed", counted before any fusion: an elementwise chain
    that a compiler would fuse counts each intermediate twice;
  * **collectives**: count and bytes per op, recorded at the entry points
    of :mod:`repro_torch.dist.collectives` and
    :mod:`repro_torch.dist.pipeline` (``"all-gather"``, ``"all-reduce"``,
    ``"reduce-scatter"``, ``"all-to-all"``, ``"collective-permute"`` for
    the ring's send/recv), each the bytes of its result, the reference's
    convention, and the bytes by the group's rank count (which link they
    cross); a group of one rank moves nothing and counts nothing;
  * **peak bytes**: the storages the run's ops create (and the arguments'),
    each counted from its first appearance until it is freed (a weak
    reference's finalizer), the largest sum at any op.

The Hopper kernels launch outside aten, where no mode sees them: each
kernel wrapper runs through :meth:`Census.kernel`, which pauses the
counting (so that the CPU's plain version counts nothing either) and adds
the kernel's own FLOPs and bytes by formula.  The kernels and the
collectives know nothing of this module: while a census runs it sets
their ``census_hook`` (:mod:`repro_torch.kernels.dispatch`,
:mod:`repro_torch.dist.collectives`) to :func:`active`.
So the same cell counts the same on the card, on CPU tensors and on meta
tensors.  Validated against the analytic ``model_flops`` in the tests
(within the remat factor) and, on the card, against the meta census of
the same step.
"""
from __future__ import annotations

import weakref

import torch
from torch.utils._python_dispatch import (TorchDispatchMode,
                                          _disable_current_modes,
                                          _get_current_dispatch_mode_stack)
from torch.utils.flop_counter import flop_registry

from repro_torch.dist import collectives
from repro_torch.kernels import dispatch

_aten = torch.ops.aten
# allocations, which write no element (views are told by their schema)
_NO_TRAFFIC = {_aten.empty.memory_format, _aten.empty_strided.default,
               _aten.empty_like.default}
_COLLECTIVE_NS = ("c10d", "_c10d_functional")
_running = 0            # censuses entered and not yet left (any thread)


def _tensors(x):
    """The tensors of an op's arguments or results: tensors, and lists,
    tuples and dicts of them (nested), scalars skipped."""
    if isinstance(x, torch.Tensor):
        yield x
    elif isinstance(x, (list, tuple)):
        for v in x:
            yield from _tensors(v)
    elif isinstance(x, dict):
        for v in x.values():
            yield from _tensors(v)


def tensor_bytes(*trees) -> int:
    """Bytes of every tensor in ``trees`` (elements times their size)."""
    return sum(t.numel() * t.element_size() for t in _tensors(trees))


class _Mode(TorchDispatchMode):
    def __init__(self, census: "Census"):
        super().__init__()
        self.census = census

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        c = self.census
        formula = flop_registry.get(func._overloadpacket)
        if formula is not None:
            c.flops_aten += formula(*args, **kwargs, out_val=out)
        if func.namespace not in _COLLECTIVE_NS and not func.is_view \
                and func not in _NO_TRAFFIC:
            c.bytes += tensor_bytes(args, kwargs, out)
        c.track(out)
        return out


class Census:
    """Counts of what runs inside ``with Census() as c:`` (see the module
    docstring); :meth:`result` gives them in the reference's keys."""

    def __init__(self):
        self.flops_aten = 0
        self.flops_kernels = 0.0
        self.bytes = 0
        self.collectives: dict = {}
        self.by_ranks: dict = {}
        self.kernels: dict = {}
        self.live = 0
        self.peak = 0
        self._storages: dict = {}
        self._mode = None

    # -- context ------------------------------------------------------------
    def __enter__(self):
        global _running
        if _running == 0:
            dispatch.census_hook = collectives.census_hook = active
        _running += 1
        self._mode = _Mode(self)
        self._mode.__enter__()
        return self

    def __exit__(self, *exc):
        global _running
        self._mode.__exit__(*exc)
        _running -= 1
        if _running == 0:
            dispatch.census_hook = collectives.census_hook = None
        return False

    # -- what the run reports ---------------------------------------------------
    def track(self, tree) -> None:
        """Count the storages of ``tree``'s tensors as live from now until
        they are freed."""
        for t in _tensors(tree):
            st = t.untyped_storage()
            key = id(st)
            if key in self._storages:
                continue
            n = st.nbytes()
            self._storages[key] = n
            weakref.finalize(st, self._free, key)
            self.live += n
            self.peak = max(self.peak, self.live)

    def _free(self, key) -> None:
        self.live -= self._storages.pop(key, 0)

    def record(self, op: str, nbytes: int, ranks: int) -> None:
        """One collective of ``nbytes`` (its result's) over a group of
        ``ranks``."""
        rec = self.collectives.setdefault(op, {"count": 0, "bytes": 0})
        rec["count"] += 1
        rec["bytes"] += nbytes
        key = str(ranks)
        self.by_ranks[key] = self.by_ranks.get(key, 0) + nbytes

    def kernel(self, name: str, fn, flops, args, kwargs):
        """``fn(*args, **kwargs)``, a hand-written kernel's wrapper, run
        with the counting paused; adds ``flops(out, *args, **kwargs)`` and
        the bytes of its tensor arguments and outputs -> its output."""
        with _disable_current_modes():
            out = fn(*args, **kwargs)
            self.flops_kernels += float(flops(out, *args, **kwargs))
        self.bytes += tensor_bytes(args, kwargs, out)
        self.kernels[name] = self.kernels.get(name, 0) + 1
        self.track(out)
        return out

    @property
    def flops(self) -> float:
        return float(self.flops_aten) + self.flops_kernels

    def result(self) -> dict:
        coll = {k: dict(v) for k, v in sorted(self.collectives.items())}
        return {
            "flops_per_device": self.flops,
            "collectives": coll,
            "collective_bytes_per_device": sum(v["bytes"] for v in coll.values()),
            "collective_bytes_by_ranks": dict(sorted(self.by_ranks.items(),
                                                     key=lambda kv: int(kv[0]))),
            "bytes_per_device": float(self.bytes),
            "peak_bytes": int(self.peak),
            "kernels": dict(sorted(self.kernels.items())),
        }


def active() -> Census | None:
    """The innermost census whose counting is on, else None."""
    for mode in reversed(_get_current_dispatch_mode_stack()):
        if isinstance(mode, _Mode):
            return mode.census
    return None


def census(fn, *args, **kwargs):
    """Run ``fn(*args, **kwargs)`` once under a :class:`Census` ->
    ``(result, counts)``; the arguments' storages count as live from the
    start (``argument_bytes`` in ``counts``)."""
    with Census() as c:
        c.track(list(args) + list(kwargs.values()))
        arg_bytes = c.live
        out = fn(*args, **kwargs)
    counts = c.result()
    counts["argument_bytes"] = int(arg_bytes)
    return out, counts
