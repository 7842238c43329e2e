"""One rank's collectives and live memory over a traced step (the port's
counterpart of ``repro.launch.roofline.parse_collective_bytes`` and of the
reference's ``memory_analysis``).

``StepRecorder`` is a dispatch mode. Entered inside a ``FakeTensorMode``
(the dry run's sharded trace on the fake process-group backend) or around
real tensors (the MoE mesh paths over gloo or NCCL), it lets DTensor
desugar each op into local ops first (it returns ``NotImplemented`` for
DTensor arguments, as ``CommDebugMode`` does) and then sees what one rank
runs:

- every collective, by the reference's five kinds (``all-reduce``,
  ``all-gather``, ``reduce-scatter``, ``all-to-all``,
  ``collective-permute``) with its **result bytes**, which is what the
  reference's ``_shape_bytes`` sums from an HLO line: the ``_c10d_functional``
  ops that DTensor and ``models.moe`` issue, their legacy
  ``c10d_functional`` names, the ``_c10d_functional_autograd`` forms, and
  the in-place ``c10d`` ops of ``torch.distributed``'s eager API (whose
  first argument is the result). A collective of another kind (a
  broadcast, a scatter) is recorded under its own op name, not dropped.
- the bytes of every local storage alive at each op: ``peak_bytes`` is
  their largest sum over the step, the tracked arguments included.

The port's layers run in a Python loop, so every call of a collective is
seen where it runs: the counts are the reference's trip-count-multiplied
bytes, and its ``collectives_raw_body_once`` (a loop body's bytes counted
once) has no counterpart and is not reported.
"""
from __future__ import annotations

import weakref
from collections import defaultdict

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten

KINDS = ("all-reduce", "all-gather", "reduce-scatter", "all-to-all",
         "collective-permute")

# op name (namespace-free) -> kind, for the functional ops (result: the
# op's output) and the eager c10d ops (result: their first argument)
_FUNCTIONAL = {
    "all_reduce": "all-reduce", "all_reduce_": "all-reduce",
    "all_reduce_coalesced": "all-reduce",
    "all_reduce_coalesced_": "all-reduce",
    "all_gather_into_tensor": "all-gather",
    "all_gather_into_tensor_out": "all-gather",
    "all_gather_into_tensor_coalesced": "all-gather",
    "reduce_scatter_tensor": "reduce-scatter",
    "reduce_scatter_tensor_coalesced": "reduce-scatter",
    "all_to_all_single": "all-to-all",
    "shard_dim_alltoall": "all-to-all",
    "broadcast": "broadcast", "broadcast_": "broadcast",
}
_EAGER = {
    "allreduce_": "all-reduce", "allreduce_coalesced_": "all-reduce",
    "allgather_": "all-gather", "_allgather_base_": "all-gather",
    "allgather_coalesced_": "all-gather",
    "allgather_into_tensor_coalesced_": "all-gather",
    "reduce_scatter_": "reduce-scatter",
    "_reduce_scatter_base_": "reduce-scatter",
    "reduce_scatter_tensor_coalesced_": "reduce-scatter",
    "alltoall_": "all-to-all", "alltoall_base_": "all-to-all",
    "send": "collective-permute", "recv_": "collective-permute",
    "recv_any_source_": "collective-permute",
    "broadcast_": "broadcast", "scatter_": "scatter", "gather_": "gather",
    "reduce_": "reduce",
}
_FUNCTIONAL_NS = ("_c10d_functional", "c10d_functional",
                  "_c10d_functional_autograd", "_dtensor")


def collective_kind(func):
    """(kind, whether the result is the first argument) of an op, or
    (None, False) for an op that is no collective."""
    ns = func.namespace
    name = func._schema.name.split("::")[-1]
    if ns in _FUNCTIONAL_NS:
        return _FUNCTIONAL.get(name), False
    if ns == "c10d":
        return _EAGER.get(name), True
    return None, False


def tensor_bytes(tree) -> int:
    """Bytes of the tensors in a (nested) result."""
    return sum(t.numel() * t.element_size() for t in tree_flatten(tree)[0]
               if isinstance(t, torch.Tensor))


def _storages(t):
    if not isinstance(t, torch.Tensor):
        return []
    try:
        return [t.untyped_storage()]
    except (NotImplementedError, RuntimeError):
        return []        # a wrapper subclass without a storage of its own


class StepRecorder(TorchDispatchMode):
    """Collective result bytes by kind, and live local storage, of the ops
    run inside it (this module's docstring). ``track(tree)`` counts
    tensors made before it (a step's arguments) as live."""

    def __init__(self):
        super().__init__()
        self.bytes = defaultdict(int)
        self.calls = defaultdict(int)
        self.live = 0
        self.peak = 0
        self._seen = {}         # id(storage) -> (weakref, nbytes)
        self._fake_mode = None
        self._inferring = 0

    def __enter__(self):
        from torch._guards import active_fake_mode
        self._fake_mode = active_fake_mode()
        self._unpatch = self._skip_shape_inference()
        return super().__enter__()

    def __exit__(self, *exc):
        self._unpatch()
        return super().__exit__(*exc)

    def _skip_shape_inference(self):
        """DTensor infers an op's global output shape by running it on
        global-shaped fake tensors, under the fake mode in force: those ops
        are no rank's work, so the recorder passes them by while
        ``ShardingPropagator._propagate_tensor_meta_non_cached`` runs.
        Returns the undo (a no-op where this torch has no such method)."""
        try:
            from torch.distributed.tensor._sharding_prop import \
                ShardingPropagator as prop
            orig = prop._propagate_tensor_meta_non_cached
        except (ImportError, AttributeError):
            return lambda: None
        rec = self

        def wrapped(self_, *args, **kwargs):
            rec._inferring += 1
            try:
                return orig(self_, *args, **kwargs)
            finally:
                rec._inferring -= 1

        prop._propagate_tensor_meta_non_cached = wrapped

        def undo():
            prop._propagate_tensor_meta_non_cached = orig
        return undo

    def track(self, tree):
        for t in tree_flatten(tree)[0]:
            self._track(_local_of(t))
        return self

    def _forget(self, key, nbytes, _ref=None):
        if self._seen.pop(key, None) is not None:
            self.live -= nbytes

    def _track(self, t):
        for st in _storages(t):
            key = id(st)
            if key in self._seen and self._seen[key][0]() is st:
                continue
            nbytes = st.nbytes()
            ref = weakref.ref(st, lambda r, k=key, n=nbytes:
                              self._forget(k, n))
            self._seen[key] = (ref, nbytes)
            self.live += nbytes
            self.peak = max(self.peak, self.live)

    def live_bytes(self, tree) -> int:
        """Bytes of the distinct local storages of ``tree`` (a step's
        outputs)."""
        seen, total = set(), 0
        for t in tree_flatten(tree)[0]:
            for st in _storages(_local_of(t)):
                if id(st) not in seen:
                    seen.add(id(st))
                    total += st.nbytes()
        return total

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if any(_is_dtensor_type(t) for t in types):
            return NotImplemented       # let DTensor desugar into local ops
        kwargs = kwargs or {}
        if self._inferring:
            return func(*args, **kwargs)
        from torch._guards import active_fake_mode
        fake = active_fake_mode()
        if func is torch.ops._c10d_functional.wait_tensor.default and fake:
            out = args[0]   # the fake kernel makes a new tensor; eager waits
        else:
            out = func(*args, **kwargs)
        kind, in_place = collective_kind(func)
        if kind is not None:
            self.bytes[kind] += tensor_bytes(args[0] if in_place else out)
            self.calls[kind] += 1
        if fake is self._fake_mode:     # not DTensor's own shape inference
            for t in tree_flatten(out)[0]:
                self._track(t)
        return out

    def collectives(self) -> dict:
        """{kind: result bytes} of the kinds seen, the five first."""
        order = list(KINDS) + sorted(k for k in self.bytes if k not in KINDS)
        return {k: int(self.bytes[k]) for k in order if k in self.bytes}


def _is_dtensor_type(t) -> bool:
    return t.__name__ == "DTensor"


def _local_of(t):
    """A DTensor's local shard; any other tensor as it is."""
    return t.to_local() if type(t).__name__ == "DTensor" else t
