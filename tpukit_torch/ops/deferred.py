"""The weight gradients of one gradient bucket deferred out of the
backward's activation chain, so that the other buckets' wires can be
issued while those products still have to run.

tpukit's hand-placed bucket wire (`--grad_buckets N` under `DataParallel`
and `FSDP`) is hidden by XLA's scheduler: each bucket's collective depends
only on its own leaves' gradients, and the scheduler runs it beside the
rest of the backward. An eager backward runs in autograd's order, and the
port's `layers` leaves are stacked (one tensor a leaf, every layer a view
of it), so every bucket that holds one completes only when the backward has
passed layer 0. This module gives the eager step the split of the backward
that zero-bubble pipeline schedules use, for the bucket issued last: the
activation-gradient chain (dx) runs first, with every other weight
product in place, and the weight products (dW) of the last bucket wait.

While a `Deferral` is active (`with deferral.active():` around the
forward), each op of the model that reads parameters goes through `run`
(`ops/layers.py`'s `linear` and `layer_norm`, the fused QKV product, the
row-parallel product, the embeddings). An op that reads no leaf of `late`
is the plain call. One that does is built twice over the same ATen ops: on
a detached copy of its activation and of its weights, as a small graph of
its own, and, in the step's graph, as one `_Bridge` node whose backward
takes only dx of that small graph. The weights' gradients stay in the
small graph until a callback queued on the backward's graph task
(`Variable._execution_engine.queue_callback`, as DDP's reducer finalizes)
runs them, inside the backward: every other bucket is handed to the caller
first (`on_bucket`), then half the deferred products run, then
`on_midway()`, then the other half and the last bucket. The wire's own
work runs inside a node of its own (`Deferral.wire`), so the comm audit's
clock counts it as the wire's and not as the model's backward.

Each product is the autograd formula of the same op on the same operands
in the same layout (the small graph is the op itself), and a stacked leaf's
gradient is `torch.stack` of its layers', as `torch.unbind`'s backward
builds it: the gradients are bit-equal to one `torch.autograd.grad` of the
whole step. Leaves read outside a deferred op are captured as their
gradient arrives; a leaf read both inside and outside one raises. The
memory this costs is the deferred ops' output gradients, held from their
op's backward to the end of the chain: one bucket's.
"""

from __future__ import annotations

import contextlib
import threading

import torch

_state = threading.local()


def _current():
    return getattr(_state, "deferral", None)


def run(fn, x, weights: dict, *args):
    """`fn(x, weights, *args)`: an op of the model that reads the parameter
    tensors in the dict `weights` (views of leaves, or leaves). Under an
    active `Deferral` whose `late` leaves it reads, the weights' gradients
    are deferred; otherwise this is the plain call. `x` is the activation
    (None where the op has none, as the embeddings)."""
    d = _current()
    if d is None:
        return fn(x, weights, *args)
    return d.bridge(fn, x, weights, *args)


def _outside(fn, *args):
    """`fn(*args)` with no `Deferral` active (an op's own inner ops, as the
    fused QKV's `linear`, are part of it)."""
    prev = _current()
    _state.deferral = None
    try:
        return fn(*args)
    finally:
        _state.deferral = prev


def _flat(tree: dict) -> list:
    out = []
    for v in tree.values():
        out.extend(_flat(v) if isinstance(v, dict) else [v])
    return out


def _map(tree: dict, fn) -> dict:
    return {k: _map(v, fn) if isinstance(v, dict) else fn(v) for k, v in tree.items()}


class _Product:
    """One op's deferred weight products: its small graph (`y` over the
    detached activation `x` and weights `ws`), the leaf slot of each weight,
    and the gradient of `y` once the backward has reached it."""

    __slots__ = ("y", "x", "ws", "slots", "grad", "done")

    def __init__(self, y, x, ws, slots):
        self.y, self.x, self.ws, self.slots = y, x, ws, slots
        self.grad = None
        self.done = False


class _Bridge(torch.autograd.Function):
    """The op in the step's graph: forward its output, backward only dx."""

    @staticmethod
    def forward(ctx, product, inp):
        ctx.product = product
        return product.y.detach()

    @staticmethod
    def backward(ctx, g):
        p = ctx.product
        p.grad = g
        if p.x is None:
            return None, None
        (dx,) = torch.autograd.grad(p.y, p.x, g, retain_graph=True)
        return None, dx


class _Capture(torch.autograd.Function):
    """A leaf as the forward reads it: an alias whose gradient, where one
    reaches it (a leaf read outside a deferred op), is kept for the
    bucket."""

    @staticmethod
    def forward(ctx, anchor, leaf, deferral, k):
        ctx.deferral, ctx.k = deferral, k
        return leaf.detach()

    @staticmethod
    def backward(ctx, g):
        ctx.deferral._captured[ctx.k] = g
        return None, None, None, None


class _Root(torch.autograd.Function):
    """The objective, whose backward (the first node to run) queues the
    deferred products on the graph task."""

    @staticmethod
    def forward(ctx, objective, deferral):
        ctx.deferral = deferral
        return objective.view_as(objective)

    @staticmethod
    def backward(ctx, g):
        torch.autograd.Variable._execution_engine.queue_callback(ctx.deferral._finish)
        return g, None


class _Wire(torch.autograd.Function):
    """A node that runs `box[0]()` as its backward: the wire's work, run
    from the callback inside a node, where the audit's clock attributes it
    to the collective it issues."""

    @staticmethod
    def forward(ctx, t, box):
        ctx.box = box
        return t.view_as(t)

    @staticmethod
    def backward(ctx, g):
        ctx.box[0]()
        return None, None


class Deferral:
    """The backward of one step over the tensors `leaves` (the tree's
    leaves, whole: the parameters, or FSDP's gathered copies), with the
    weight products of the ops that read a leaf of `late` (indices into
    `leaves`: the bucket issued last) deferred.

    1. `tree = deferral.capture(params)`: the tree the forward reads.
    2. The forward, under `with deferral.active():`.
    3. `deferral.backward(objective, buckets, last, on_bucket, on_midway)`
       runs the backward: the dx chain, then for each bucket `b` but
       `last` (`buckets[b]` are indices into `leaves`) the deferred
       products it shares with the last, if any, and `on_bucket(b, {k:
       grad})` inside a wire node (`wire`); then half the other deferred
       products, `on_midway()` (which runs its wire work through `wire`
       itself), the rest, and `on_bucket(last, ...)`. It returns every
       leaf's gradient (those in no bucket too)."""

    def __init__(self, leaves: list, late):
        self.leaves = list(leaves)
        self.late = set(late)
        self.anchor = torch.zeros((), device=self.leaves[0].device, requires_grad=True)
        self._index: dict[int, int] = {}
        self._products: list[_Product] = []
        self._captured: dict[int, torch.Tensor] = {}
        self._slots: dict[int, set] = {}  # leaf -> the layers (None: whole) deferred ops read
        self._grads: dict = {}  # (leaf, layer or None) -> gradient
        self._box = [None]
        seed = torch.zeros((), device=self.anchor.device, requires_grad=True)
        self._wire_out = _Wire.apply(seed, self._box)
        self._wire_grad = torch.ones((), device=self.anchor.device)
        self._plan = None
        self.result: list | None = None

    # -- forward ------------------------------------------------------------

    def capture(self, tree: dict) -> dict:
        """`tree` (whose leaves are the tensors of `leaves`) with every leaf
        replaced by its capturing alias."""
        pos = {id(t): k for k, t in enumerate(self.leaves)}

        def alias(t):
            k = pos[id(t)]
            a = _Capture.apply(self.anchor, t.detach(), self, k)
            self._index[id(a)] = k
            return a

        return _map(tree, alias)

    @contextlib.contextmanager
    def active(self):
        prev = _current()
        _state.deferral = self
        try:
            yield self
        finally:
            _state.deferral = prev

    def _slot(self, w: torch.Tensor) -> tuple:
        """(leaf index, layer or None) of a weight the forward read: a
        captured alias, or one layer of it from `torch.unbind`."""
        base = w._base if w._base is not None else w
        k = self._index.get(id(base))
        if k is None:
            raise ValueError("a deferred op read a weight that is not a leaf of the step's "
                             "tree, nor one layer of a stacked leaf")
        if base is w:
            return k, None
        layer, rem = divmod(w.storage_offset() - base.storage_offset(), max(base.stride(0), 1))
        if (tuple(w.shape) != tuple(base.shape[1:]) or not base.is_contiguous()
                or tuple(w.stride()) != tuple(base.stride()[1:]) or rem):
            raise ValueError(f"a deferred op read a view of leaf {k} that is not one layer "
                             "of it (a contiguous stack)")
        return k, layer

    def bridge(self, fn, x, weights: dict, *args):
        slots = [self._slot(w) for w in _flat(weights)]
        if not any(k in self.late for k, _ in slots):
            return _outside(fn, x, weights, *args)
        for k, layer in slots:
            self._slots.setdefault(k, set()).add(layer)
        ws = _map(weights, lambda w: w.detach().requires_grad_(True))
        xl = None if x is None else x.detach().requires_grad_(x.requires_grad)
        with torch.enable_grad():
            y = _outside(fn, xl, ws, *args)
        grad_x = x is not None and x.requires_grad
        product = _Product(y, xl if grad_x else None, _flat(ws), slots)
        self._products.append(product)
        return _Bridge.apply(product, x if grad_x else self.anchor)

    # -- backward -----------------------------------------------------------

    def wire(self, fn) -> None:
        """Run `fn()` inside a node of its own (the wire's work)."""
        self._box[0] = fn
        torch.autograd.backward(self._wire_out, self._wire_grad, retain_graph=True)
        self._box[0] = None

    def backward(self, objective: torch.Tensor, buckets: list[list[int]], last: int,
                 on_bucket, on_midway=None) -> list:
        self._plan = (buckets, last, on_bucket, on_midway)
        torch.autograd.grad(_Root.apply(objective, self), [self.anchor], allow_unused=True)
        if self.result is None:
            raise RuntimeError("the deferred products did not run: the objective's backward "
                               "never reached them")
        return self.result

    def _run(self, p: _Product) -> None:
        if p.done:
            return
        if p.grad is None:
            raise RuntimeError("a deferred op's output got no gradient in the backward")
        gs = torch.autograd.grad(p.y, p.ws, p.grad)
        for slot, g in zip(p.slots, gs):
            if slot in self._grads:
                raise ValueError(f"leaf {slot[0]} is read by two deferred ops")
            self._grads[slot] = g
        p.done = True
        p.y = p.x = p.ws = p.grad = None

    def _leaf_grad(self, k: int) -> torch.Tensor:
        layers = self._slots.get(k)
        if not layers:
            if k not in self._captured:
                raise RuntimeError(f"leaf {k} got no gradient in the deferred backward")
            return self._captured.pop(k)
        if k in self._captured:
            raise ValueError(f"leaf {k} is read both by a deferred op and outside one: its "
                             "gradient would be split")
        if layers == {None}:
            return self._grads.pop((k, None))
        n = self.leaves[k].shape[0] if self.leaves[k].dim() else 0
        if layers != set(range(n)):
            raise ValueError(f"leaf {k} is read whole and by layer, or not in every layer, "
                             "by deferred ops")
        return torch.stack([self._grads.pop((k, i)) for i in range(n)])

    def _finish(self) -> None:
        """The callback: every bucket but the last (after the deferred
        products it shares with the last), half the other deferred
        products, `on_midway`, the rest, then the last bucket."""
        buckets, last, on_bucket, on_midway = self._plan
        grads: list = [None] * len(self.leaves)
        products = self._products[::-1]  # the backward's order

        def hand(b):
            got = {k: self._leaf_grad(k) for k in buckets[b]}
            for k, g in got.items():
                grads[k] = g
            self.wire(lambda: on_bucket(b, got))

        for b in range(len(buckets)):
            if b != last:
                idxs = set(buckets[b])
                for p in products:
                    if any(k in idxs for k, _ in p.slots):
                        self._run(p)
                hand(b)
        rest = [p for p in products if not p.done]
        for i, p in enumerate(rest):
            if i == len(rest) // 2 and on_midway is not None:
                on_midway()
            self._run(p)
        if buckets:
            hand(last)
        for k in range(len(self.leaves)):
            if grads[k] is None:
                grads[k] = self._leaf_grad(k)
        self._products.clear()
        self.result = grads


def late_bucket(reads: list[int]) -> int:
    """The bucket whose products to defer, from each bucket's count of
    weight reads in the forward: the most read (the later on a tie), so
    that the other buckets' wires have the most products still to run."""
    return max(range(len(reads)), key=lambda b: (reads[b], b))
