"""Forward-mode dual numbers for the residuals' Jacobians (≙ Ceres'
``Jet<T, N>``, which the reference's ``AutoDiffCostFunction<..., 8, 3, 6,
6>`` differentiates with).

A ``Jet`` pairs a value ``v`` (...) with its tangents ``d`` (..., n): the
derivatives of every element with respect to ``n`` variables.  Its
arithmetic and the functions below (``where``, ``sum``, ``sqrt``, ``sin``,
``cos``, ``cross``, ``cat``, ``stack``, indexing, ``reshape``) apply the
chain rule alongside the value, so a function written with them gives its
value and its Jacobian in one pass over a whole batch.  A plain tensor
among the operands is a constant; every function here also takes plain
tensors and then is the torch function itself, so ``core/lie.py`` and
``core/projection.py`` have one body for values and for jets.

Values are computed by the same torch operations, in the same order, as
on plain tensors, so a jet's value is bit for bit the plain result.  No
``torch.func`` transform is involved: those route operations that mix a
dual tensor with a constant through ``torch._refs`` wrappers, whose first
use imports ``torch._dynamo`` (and sympy) at a cost of seconds a process.
"""

from __future__ import annotations

import torch


class Jet:
    """A value (...) and its tangents (..., n), ``d.shape[:-1] ==
    v.shape``."""

    __slots__ = ("v", "d")

    def __init__(self, v: torch.Tensor, d: torch.Tensor):
        if d.shape[:-1] != v.shape:
            d = d.expand(*v.shape, d.shape[-1])
        self.v, self.d = v, d

    @property
    def shape(self):
        return self.v.shape

    @property
    def dtype(self):
        return self.v.dtype

    @property
    def device(self):
        return self.v.device

    def __getitem__(self, idx):
        idx = idx if isinstance(idx, tuple) else (idx,)
        # an index with an ellipsis ends at the value's last axis; the
        # tangent axis follows it
        d_idx = idx + (slice(None),) if Ellipsis in idx else idx
        return Jet(self.v[idx], self.d[d_idx])

    def reshape(self, shape) -> "Jet":
        v = self.v.reshape(shape)
        return Jet(v, self.d.reshape(tuple(v.shape) + (self.d.shape[-1],)))

    def __neg__(self) -> "Jet":
        return Jet(-self.v, -self.d)

    def __add__(self, other) -> "Jet":
        if isinstance(other, Jet):
            return Jet(self.v + other.v, self.d + other.d)
        return Jet(self.v + other, self.d)

    def __radd__(self, other) -> "Jet":
        return Jet(other + self.v, self.d)

    def __sub__(self, other) -> "Jet":
        if isinstance(other, Jet):
            return Jet(self.v - other.v, self.d - other.d)
        return Jet(self.v - other, self.d)

    def __rsub__(self, other) -> "Jet":
        return Jet(other - self.v, -self.d)

    def __mul__(self, other) -> "Jet":
        if isinstance(other, Jet):
            return Jet(self.v * other.v, self.d * other.v[..., None]
                       + self.v[..., None] * other.d)
        return Jet(self.v * other, self.d * _col(other))

    def __rmul__(self, other) -> "Jet":
        return Jet(other * self.v, _col(other) * self.d)

    def __truediv__(self, other) -> "Jet":
        if isinstance(other, Jet):
            v = self.v / other.v
            return Jet(v, (self.d - v[..., None] * other.d)
                       / other.v[..., None])
        return Jet(self.v / other, self.d / _col(other))

    def __rtruediv__(self, other) -> "Jet":
        v = other / self.v
        return Jet(v, -v[..., None] * self.d / self.v[..., None])


def _col(x):
    """A constant's broadcast against tangents: a trailing unit axis."""
    return x[..., None] if isinstance(x, torch.Tensor) else x


def value(x) -> torch.Tensor:
    """The value of a jet; a tensor as it is."""
    return x.v if isinstance(x, Jet) else x


def variables(x: torch.Tensor, n: int, first: int = 0) -> Jet:
    """``x`` (..., k) as the variables ``first`` .. ``first + k - 1`` of
    ``n``: tangents (..., k, n) with the identity in those columns."""
    eye = torch.eye(n, dtype=x.dtype, device=x.device)
    return Jet(x, eye[first:first + x.shape[-1]].expand(*x.shape, n))


def where(cond: torch.Tensor, a, b):
    """``torch.where`` with the tangents selected alike (a constant's are
    0).  Under ``cond`` the other branch's tangents are dropped, not
    multiplied, so a NaN-free branch gives NaN-free tangents."""
    v = torch.where(cond, value(a), value(b))
    if not isinstance(a, Jet) and not isinstance(b, Jet):
        return v
    da = a.d if isinstance(a, Jet) else 0.0
    db = b.d if isinstance(b, Jet) else 0.0
    return Jet(v, torch.where(cond[..., None], da, db))


def _dim(dim: int) -> int:
    """A value axis as an axis of the tangents."""
    return dim - 1 if dim < 0 else dim


def sum(x, dim: int, keepdim: bool = False):  # noqa: A001 (torch's name)
    if not isinstance(x, Jet):
        return torch.sum(x, dim=dim, keepdim=keepdim)
    return Jet(torch.sum(x.v, dim=dim, keepdim=keepdim),
               torch.sum(x.d, dim=_dim(dim), keepdim=keepdim))


def sqrt(x):
    if not isinstance(x, Jet):
        return torch.sqrt(x)
    v = torch.sqrt(x.v)
    return Jet(v, x.d / (2.0 * v)[..., None])


def sin(x):
    if not isinstance(x, Jet):
        return torch.sin(x)
    return Jet(torch.sin(x.v), torch.cos(x.v)[..., None] * x.d)


def cos(x):
    if not isinstance(x, Jet):
        return torch.cos(x)
    return Jet(torch.cos(x.v), -torch.sin(x.v)[..., None] * x.d)


def cross(a, b):
    """The cross product over the last axis, broadcast over the others."""
    if not isinstance(a, Jet) and not isinstance(b, Jet):
        a, b = torch.broadcast_tensors(a, b)
        return torch.linalg.cross(a, b, dim=-1)
    av, bv = torch.broadcast_tensors(value(a), value(b))
    v = torch.linalg.cross(av, bv, dim=-1)
    d = 0.0
    if isinstance(a, Jet):
        d = d + torch.linalg.cross(
            *torch.broadcast_tensors(a.d, bv[..., None]), dim=-2)
    if isinstance(b, Jet):
        d = d + torch.linalg.cross(
            *torch.broadcast_tensors(av[..., None], b.d), dim=-2)
    return Jet(v, d)


def _tangents(xs, n: int) -> list:
    return [x.d if isinstance(x, Jet) else torch.zeros(
        (*x.shape, n), dtype=x.dtype, device=x.device) for x in xs]


def _n(xs) -> int | None:
    return next((x.d.shape[-1] for x in xs if isinstance(x, Jet)), None)


def cat(xs, dim: int):
    n = _n(xs)
    v = torch.cat([value(x) for x in xs], dim=dim)
    if n is None:
        return v
    return Jet(v, torch.cat(_tangents(xs, n), dim=_dim(dim)))


def stack(xs, dim: int):
    n = _n(xs)
    v = torch.stack([value(x) for x in xs], dim=dim)
    if n is None:
        return v
    return Jet(v, torch.stack(_tangents(xs, n), dim=_dim(dim)))
