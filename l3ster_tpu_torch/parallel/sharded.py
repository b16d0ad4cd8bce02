"""Shards placed on several devices: placement groups, the sharded stack and
the row exchange between groups.

The reference places shard ``p`` of a distributed or box-decomposed system on
``devices[p]`` (a ``jax.sharding.Mesh`` over ``devices[:n_shards]``), one
controller driving every device, and exchanges halos with ``ppermute``.  The
port keeps that single-controller model: one process and a list of
**placement groups**, one group per entry of ``devices`` (in list order, a
repeated entry still its own group), each holding a contiguous block of
shards as one stacked batch ``(n_in_group, ...)`` on its device.  Within a
group the systems run their one-device code unchanged; between groups, the
reference's ``ppermute`` becomes explicit copies (:class:`RowExchange`).

A solver-facing vector of a system with several groups is a
:class:`ShardedStack`: the stacked tensor cut along its leading (shard) axis
into the groups' parts, each on its device.  It behaves as that stacked
tensor under the operations the Krylov solvers and the preconditioners apply
to solver vectors (arithmetic, ``>``, ``torch.where``, ``*_like``, indexing
and reshapes and ``einsum`` that keep the shard axis leading, sums,
``linalg.norm``), so those modules have one code path whatever the
placement.  A plain tensor beside a sharded stack lives on the
first group's device (the home device): one with the stack's full leading
size is cut into the groups' parts, any other is broadcast to each group.
Reductions over the shard axis (the reference's ``psum``) sum the groups'
partial results on the home device.  A system with one group keeps plain
tensors.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch
import torch.utils._pytree

__all__ = [
    "ShardGroup", "ShardedStack", "RowExchange", "PlacedShards", "shard_groups", "resolve_home_device",
    "describe_placement",
]


@dataclass(frozen=True)
class ShardGroup:
    """Shards ``lo .. hi - 1``, stacked on ``device``."""

    lo: int
    hi: int
    device: torch.device

    @property
    def n(self) -> int:
        return self.hi - self.lo


def _full_device(d) -> torch.device:
    """A device with its index (a bare "cuda" names the current card)."""
    d = torch.device(d)
    if d.type == "cuda" and d.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return d


def resolve_home_device(device, devices):
    """The device a system with ``devices`` lives on: the first entry (or
    ``device`` when ``devices`` is None); a ``device`` that is not the first
    entry is refused."""
    if devices is None:
        return device
    if len(devices) == 0:
        raise ValueError("devices is empty")
    if device is not None and _full_device(device) != _full_device(devices[0]):
        raise ValueError(f"device={device} is not the first entry of devices ({devices[0]})")
    return devices[0]


def shard_groups(n_shards: int, devices, home: torch.device) -> list[ShardGroup]:
    """One group per entry of ``devices[:n_shards]``, in list order, holding
    contiguous blocks of shards as even as they go; ``devices=None``: one
    group on ``home``."""
    if devices is None:
        return [ShardGroup(0, n_shards, home)]
    devs = [_full_device(d) for d in devices[:n_shards]]
    blocks = np.array_split(np.arange(n_shards), len(devs))
    return [ShardGroup(int(b[0]), int(b[-1]) + 1, d) for b, d in zip(blocks, devs)]


def describe_placement(groups: list[ShardGroup]) -> str:
    """"device=<d>" for one group, else each group's shards and device."""
    if len(groups) == 1:
        return f"device={groups[0].device}"
    spans = (f"{g.lo}" if g.n == 1 else f"{g.lo}-{g.hi - 1}" for g in groups)
    return "shards " + ", ".join(f"{sp} on {g.device}" for sp, g in zip(spans, groups))


def _is_sharded(x) -> bool:
    return isinstance(x, ShardedStack)


class ShardedStack:
    """A tensor stacked along its leading axis from ``parts`` on the groups'
    devices (see the module doc).  ``device`` is the home device, where
    reductions land; ``full()`` is the stacked tensor on one device."""

    __slots__ = ("parts",)

    def __init__(self, parts):
        self.parts = list(parts)

    # -- tensor-like attributes ---------------------------------------------
    @property
    def shape(self) -> torch.Size:
        return torch.Size((sum(p.shape[0] for p in self.parts),) + tuple(self.parts[0].shape[1:]))

    @property
    def ndim(self) -> int:
        return self.parts[0].ndim

    def dim(self) -> int:
        return self.ndim

    def numel(self) -> int:
        return sum(p.numel() for p in self.parts)

    @property
    def dtype(self) -> torch.dtype:
        return self.parts[0].dtype

    @property
    def device(self) -> torch.device:
        return self.parts[0].device

    def full(self, device=None) -> torch.Tensor:
        """The stacked tensor on ``device`` (default: home)."""
        dev = self.device if device is None else torch.device(device)
        return torch.cat([p.to(dev) for p in self.parts])

    def cpu(self) -> torch.Tensor:
        return self.full("cpu")

    def numpy(self) -> np.ndarray:
        return self.cpu().numpy()

    def __array__(self, dtype=None, copy=None):
        a = self.numpy()
        return a if dtype is None else a.astype(dtype)

    def __repr__(self) -> str:
        return f"ShardedStack(shape={tuple(self.shape)}, devices={[str(p.device) for p in self.parts]})"

    # -- per-part maps ----------------------------------------------------------
    def _like(self, other) -> bool:
        return [p.shape[0] for p in other.parts] == [p.shape[0] for p in self.parts]

    def _arg(self, a, g: int, lead: int):
        """Argument ``a`` for part ``g``: its part, or a plain tensor cut (when
        it spans the full leading size) or moved."""
        if _is_sharded(a):
            if not self._like(a):
                raise ValueError("sharded stacks of different placements")
            return a.parts[g]
        if isinstance(a, torch.Tensor):
            dev = self.parts[g].device
            if a.ndim == self.ndim and a.ndim > 0 and a.shape[0] == lead and lead > 1:
                lo = sum(p.shape[0] for p in self.parts[:g])
                a = a[lo : lo + self.parts[g].shape[0]]
            return a.to(dev, non_blocking=True)
        if isinstance(a, (list, tuple)):
            return type(a)(self._arg(x, g, lead) for x in a)
        return a

    def _map(self, func, args, kwargs=None) -> "ShardedStack":
        kwargs = kwargs or {}
        lead = self.shape[0]
        out = [
            func(*(self._arg(a, g, lead) for a in args), **{k: self._arg(v, g, lead) for k, v in kwargs.items()})
            for g in range(len(self.parts))
        ]
        return ShardedStack(out)

    # -- arithmetic ---------------------------------------------------------------
    def __add__(self, o):
        return self._map(torch.add, (self, o))

    def __radd__(self, o):
        return self._map(torch.add, (o, self))

    def __sub__(self, o):
        return self._map(torch.sub, (self, o))

    def __rsub__(self, o):
        return self._map(lambda a, b: a - b, (o, self))

    def __mul__(self, o):
        return self._map(torch.mul, (self, o))

    def __rmul__(self, o):
        return self._map(torch.mul, (o, self))

    def __truediv__(self, o):
        return self._map(torch.div, (self, o))

    def __rtruediv__(self, o):
        return self._map(lambda a, b: a / b, (o, self))

    def __gt__(self, o):
        return self._map(torch.gt, (self, o))

    def abs(self):
        return self._map(torch.abs, (self,))

    def clone(self):
        return self._map(torch.clone, (self,))

    def detach(self):
        return ShardedStack([p.detach() for p in self.parts])

    # -- indexing and shapes ------------------------------------------------------
    @staticmethod
    def _keeps_lead(idx) -> tuple:
        idx = idx if isinstance(idx, tuple) else (idx,)
        if not idx or not (idx[0] is Ellipsis or (isinstance(idx[0], slice) and idx[0] == slice(None))):
            raise IndexError("a sharded stack is indexed with its shard axis kept whole")
        return idx

    def __getitem__(self, idx):
        idx = self._keeps_lead(idx)
        return ShardedStack([p[idx] for p in self.parts])

    def __setitem__(self, idx, value):
        idx = self._keeps_lead(idx)
        lead = self.shape[0]
        for g, p in enumerate(self.parts):
            p[idx] = self._arg(value, g, lead)

    def reshape(self, *shape):
        shape = tuple(shape[0]) if len(shape) == 1 and isinstance(shape[0], (tuple, list, torch.Size)) else shape
        if shape[0] not in (-1, self.shape[0]):
            raise ValueError(f"a sharded stack reshapes with its shard axis leading, not to {shape}")
        if shape[0] == -1:
            return ShardedStack([p.reshape(shape) for p in self.parts])
        return ShardedStack([p.reshape((p.shape[0],) + shape[1:]) for p in self.parts])

    view = reshape

    def sum(self, dim=None, keepdim: bool = False):
        """A sum over the shard axis sums each part over the other axes, then
        the rows of those partials on the home device in shard order: the
        order of the same sum taken in two steps on the stacked tensor."""
        dims = tuple(range(self.ndim)) if dim is None else tuple(
            d % self.ndim for d in (dim if isinstance(dim, (tuple, list)) else (dim,))
        )
        if 0 not in dims:
            return ShardedStack([p.sum(dim=dims, keepdim=keepdim) for p in self.parts])
        rest = tuple(d for d in dims if d != 0)
        rows = [p.sum(dim=rest, keepdim=True) if rest else p for p in self.parts]
        return torch.cat([r.to(self.device, non_blocking=True) for r in rows]).sum(dim=dims, keepdim=keepdim)

    # -- torch functions ------------------------------------------------------------
    _ELEMENTWISE = {
        torch.where, torch.zeros_like, torch.ones_like, torch.empty_like, torch.full_like, torch.clone,
        torch.abs, torch.add, torch.sub, torch.mul, torch.div, torch.neg, torch.Tensor.add, torch.Tensor.sub,
        torch.Tensor.mul, torch.Tensor.div, torch.Tensor.__rsub__, torch.Tensor.__rdiv__, torch.Tensor.__gt__,
        torch.Tensor.__mul__, torch.Tensor.__add__, torch.Tensor.__sub__, torch.Tensor.__truediv__,
        torch.Tensor.__radd__, torch.Tensor.__rmul__, torch.Tensor.__rtruediv__,
    }

    @classmethod
    def __torch_function__(cls, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        ref = next(a for a in list(args) + list(kwargs.values()) if _is_sharded(a))
        if func in cls._ELEMENTWISE:
            return ref._map(func, args, kwargs)
        if func is torch.Tensor.__getitem__ and not _is_sharded(args[0]):
            # a plain (home) tensor gathered at a sharded index: each group's rows
            src, idx = args
            return ShardedStack([src.to(p.device, non_blocking=True)[p] for p in idx.parts])
        if func is torch.Tensor.index_add_ and not _is_sharded(args[0]):
            # a sharded scatter-add into a plain (home) tensor: each group's
            # partial sum, added on the home device (the reference's psum)
            out, dim, idx, src = args[:4]
            for ip, sp in zip(idx.parts, src.parts):
                part = torch.zeros(out.shape, dtype=out.dtype, device=sp.device).index_add_(dim, ip, sp, **kwargs)
                out.add_(part.to(out.device, non_blocking=True))
            return out
        if func is torch.linalg.norm and len(args) == 1 and not kwargs:
            return (args[0] * args[0]).sum().sqrt()
        if func is torch.einsum:
            return cls._einsum(args[0], args[1:])
        raise NotImplementedError(f"{getattr(func, '__name__', func)} on a sharded stack")

    @staticmethod
    def _einsum(eq: str, ops):
        """``einsum`` whose sharded operands and output lead with the shard
        subscript, per group."""
        ins, out = eq.replace(" ", "").split("->")
        subs = ins.split(",")
        lead = {s[0] for s, o in zip(subs, ops) if _is_sharded(o)}
        ax = lead.pop() if len(lead) == 1 else None
        if ax is None or not out.startswith(ax) or any(ax in s for s, o in zip(subs, ops) if not _is_sharded(o)):
            raise ValueError(f"einsum {eq!r}: the sharded operands and the output must lead with the shard subscript")
        ref = next(o for o in ops if _is_sharded(o))
        return ShardedStack([
            torch.einsum(eq, *(o.parts[g] if _is_sharded(o) else o.to(ref.parts[g].device) for o in ops))
            for g in range(len(ref.parts))
        ])


torch.utils._pytree.register_pytree_node(
    ShardedStack, lambda s: (s.parts, None), lambda parts, _: ShardedStack(parts),
    serialized_type_name="l3ster_tpu_torch.parallel.sharded.ShardedStack",
)


class PlacedShards:
    """The placement helpers of a system with placement groups ``_groups``
    (the distributed and the box systems)."""

    _groups: list

    def _place(self, t):
        """A stacked tensor (n_shards, ...) in this system's placement: each
        group's shards on its device (a :class:`ShardedStack` over several
        groups, else the tensor on the one group's device)."""
        if isinstance(t, ShardedStack):
            return t
        if len(self._groups) == 1:
            return t.to(self._groups[0].device)
        return ShardedStack([t[g.lo : g.hi].to(g.device) for g in self._groups])

    def _split(self, x) -> list:
        """The groups' parts of a stacked vector (sharded, or plain on any device)."""
        return self._place(x).parts if len(self._groups) > 1 else [self._place(x)]

    @staticmethod
    def _join(parts: list):
        return parts[0] if len(parts) == 1 else ShardedStack(parts)

    @staticmethod
    def _full(x) -> torch.Tensor:
        """The stacked tensor on the home device."""
        return x.full() if isinstance(x, ShardedStack) else x


class RowExchange:
    """Row ``q`` of the result is row ``src[q]`` of the source, across the
    groups' parts (rows are shards): ``__call__(parts)`` returns the groups'
    result parts.  Where a row's source lies in another group, it is cut out,
    copied to the receiving group's device (``non_blocking``: PyTorch orders a
    copy between devices after both devices' current streams) and placed;
    rows with ``active`` False carry nothing and are zero there.  With one
    group the result is the gather ``parts[0][src]``."""

    def __init__(self, groups: list[ShardGroup], src: np.ndarray, active: np.ndarray | None = None):
        src = np.asarray(src, dtype=np.int64)
        self.groups = groups
        if len(groups) == 1:
            self.gather, self.plan, self.cross_rows = torch.as_tensor(src, device=groups[0].device), None, 0
            return
        self.gather = None
        active = np.ones(len(src), dtype=bool) if active is None else np.asarray(active, dtype=bool)
        owner = np.concatenate([np.full(g.n, i) for i, g in enumerate(groups)])
        # per receiving group: (source group, rows here, rows there) of each source group
        self.plan = []
        for g in groups:
            q = np.arange(g.lo, g.hi)
            pieces = []
            for hj, h in enumerate(groups):
                sel = q[active[q] & (owner[src[q]] == hj)]
                if len(sel):
                    pieces.append((hj, torch.as_tensor(sel - g.lo, device=g.device),
                                   torch.as_tensor(src[sel] - h.lo, device=h.device)))
            self.plan.append(pieces)
        self.cross_rows = sum(len(dst) for gi, ps in enumerate(self.plan) for hj, dst, _ in ps if hj != gi)

    def __call__(self, parts: list[torch.Tensor]) -> list[torch.Tensor]:
        if self.gather is not None:
            return [parts[0][self.gather]]
        out = []
        for gi, (g, pieces) in enumerate(zip(self.groups, self.plan)):
            o = parts[gi].new_zeros((g.n,) + tuple(parts[gi].shape[1:]))
            for hj, dst, rows in pieces:
                got = parts[hj][rows]
                o[dst] = got if hj == gi else got.to(g.device, non_blocking=True)
            out.append(o)
        return out
